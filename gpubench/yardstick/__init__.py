"""The arithmetic every metric shares, kept with the benchmark so that a
change to the program cannot change it."""
