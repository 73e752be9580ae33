"""Host-side graph containers, adjacency build and the ELL operator."""
