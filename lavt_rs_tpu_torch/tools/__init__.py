"""Command-line tools of the port."""
