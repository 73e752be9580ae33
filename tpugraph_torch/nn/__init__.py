"""Graph layers."""
