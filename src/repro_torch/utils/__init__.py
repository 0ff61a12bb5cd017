"""Utilities (counterpart of ``repro.utils``): ``comms``, the census of a
step's collectives, operations, bytes and memory."""
