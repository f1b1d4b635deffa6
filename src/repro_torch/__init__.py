"""PyTorch / CUDA port of the Pond reproduction (``repro`` is the reference).

The sub-packages mirror ``repro``'s layout file by file.  Nothing here
imports ``jax`` or ``repro``; what the port needs from the reference's
host-side modules it keeps as its own copy.
"""
