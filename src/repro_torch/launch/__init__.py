"""Command-line launchers."""
