"""The port's benchmark: one cell, one run, one result line."""
