from . import head, network, topology  # noqa: F401
