"""Plain references, importing nothing of the program."""
