"""Hardware facts the port reads (peak rates per device kind)."""
