"""The encoder, the MTL heads, the attribute channel and the model with its losses."""
