"""Example trials of the port, each the counterpart of a trial under the
repo's ``examples/``."""
