"""PyTorch/CUDA port of visiontransformer_tpu for NVIDIA Hopper (H100).

A second package beside the JAX one: the same ViT segmentation model and
serving platform, with the TPU package's Pallas kernels rewritten by hand
in CUDA C++ for sm_90a (``csrc/``, built at first use by
``ops/_build.py``). Importing the package imports nothing and builds
nothing.
"""
