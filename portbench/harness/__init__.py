"""The harness: one general runner for every cell (``runner``), the
manifest's files found by name (``manifest``), the traced run's records
(``trace``) and the comparison of the port with the reference (``compare``)."""
