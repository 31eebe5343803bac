"""The measurement layer of the port: microbenchmarks, campaigns and the
calibration tables they produce."""
