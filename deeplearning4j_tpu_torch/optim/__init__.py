"""Optimization of the PyTorch port: schedules, updaters, listeners and
the fit-loop executor."""
