"""Round runtime: planning, the in-process training context, round
strategies, validation, checkpointing and the round loop."""
