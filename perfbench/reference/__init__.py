"""The plain reference the output check holds the program against; it
imports nothing of the program."""
