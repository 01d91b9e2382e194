"""Model stack of the port: layers, attention, value head, backbone and
policy (the serving half)."""
