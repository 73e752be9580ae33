"""Graph layers and the highway gate."""
