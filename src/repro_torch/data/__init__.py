"""Deterministic synthetic data pipelines (graphs, click logs), numpy."""
