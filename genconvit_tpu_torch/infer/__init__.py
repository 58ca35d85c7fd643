"""Inference: per-video aggregation and the Predictor."""
