"""The benchmark's inputs, made from ``--seed``: weights, images, labels,
the stage-1 bank, the PK order, the evaluation set. The same seed gives
the same inputs; the sizes never depend on it."""
