"""Optimizer, LR schedules and the synthetic data pipeline of the port."""
