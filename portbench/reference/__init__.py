"""Plain PyTorch references, one ``reference/<kind>.py`` a kind; none imports the program."""
