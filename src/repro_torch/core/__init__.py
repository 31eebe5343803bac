"""The measurement layer of the port: microbenchmarks, campaigns, the
calibration tables they produce and the cost model that reads them."""
