"""What every cell shares: finding a cell's files by name (``cells``),
the device and its guards (``device``), seeded inputs and weights
(``inputs``, ``weights``), comparisons against the reference
(``compare``), the profiler's trace (``trace``), FLOP and byte arithmetic
(``flopcount``) and the card's published peaks (``peaks``)."""
