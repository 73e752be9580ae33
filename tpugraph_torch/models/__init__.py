"""The encoder and the model with its alignment losses."""
