"""In-task execution: what a Core API entrypoint receives."""
