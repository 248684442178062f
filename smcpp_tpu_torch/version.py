__version__ = version = "0.1.0"
