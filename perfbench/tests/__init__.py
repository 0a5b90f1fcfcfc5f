"""CPU tests of the benchmark, and one test of a short cell on the card."""
