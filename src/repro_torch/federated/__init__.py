"""Federated fine-tuning of the port (paper Sec. III): clients, server,
simulation."""
