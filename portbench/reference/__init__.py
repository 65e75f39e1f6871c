"""Plain reference of the scheme: imports nothing of the program."""
