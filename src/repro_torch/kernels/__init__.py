"""The port's Hopper kernels (``csrc/``), their plain versions (``ref``),
the public wrappers (``ops``) and the SpMV engine (``engine``).  Importing
this package builds nothing: the CUDA library is built at first launch."""
