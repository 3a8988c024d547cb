from .bundle import DataBundle  # noqa: F401
