"""Model stack of the port: layers, the dense trunk, the model API and
the converter from JAX parameter trees."""
