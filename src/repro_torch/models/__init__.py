"""Model stack of the port: layers, the trunk (dense, rwkv6 and hymba),
the model API and the converter from JAX parameter trees."""
