"""PyTorch port of the template-based CNN accelerator system, on hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

``repro`` (JAX, Pallas kernels for the TPU) is the reference; this package
mirrors its layout: ``core`` (numerics, tiling, DSE, engine, template),
``kernels`` (the CUDA kernels' wrappers, their plain versions and the route
wrappers) and ``models`` (the CNN zoo).  It imports no JAX.
"""
