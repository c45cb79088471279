"""Training: the train step, its optimizers and metric accumulation."""
