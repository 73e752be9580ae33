"""Datasets: the synthetic DBP15K-shaped generator."""
