"""CPU tests of the benchmark (and, marked ``cuda``, one on the card)."""
