"""Index kinds: ``kinds/<kind>.py`` builds the program's index of one kind and drives its search."""
