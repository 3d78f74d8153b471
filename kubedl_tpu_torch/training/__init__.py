"""Training path of the port: data, the single-device trainer, the entry."""
