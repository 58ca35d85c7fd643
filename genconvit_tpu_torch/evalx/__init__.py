"""Offline evaluation: metrics from result JSONs (numpy only) and plots
(matplotlib, loaded when a plot is drawn)."""
