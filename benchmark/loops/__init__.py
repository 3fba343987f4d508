"""The loops that drive a traffic mix, one module a mix's `loop`
(closed.py); the registry finds them by name."""
