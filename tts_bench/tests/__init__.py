"""CPU tests of the benchmark (the card test is marked `gpu`)."""
