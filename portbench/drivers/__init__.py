"""One module per driver: the loop that feeds a cell's traffic to the program."""
