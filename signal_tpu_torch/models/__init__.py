"""Models of the port: the CLIP tower, SIM, the Signal module, weight conversion."""
