"""Model code of the port: the Llama decoder and paged attention."""
