"""Operations and bytes by shape: the whole step's operations per item (for
the ``mfu`` metrics) and each hand kernel's least time (for the roofline
shares), against the published peaks of ``peaks.py``."""
