"""PyTorch and CUDA port of incubator_predictionio_tpu, for NVIDIA Hopper.

The JAX package beside this one is the reference; this package imports
nothing from it and nothing of JAX. Its entry points run on the CUDA device
unless the caller passes ``device="cpu"``; a kernel wrapper given a CUDA
tensor launches its hand-written kernel (``csrc/``) or raises.

Ported so far: recommendation serving — a model carried across from numpy
(``models/recommendation/convert.py``) served over HTTP
(``servers/prediction_server.py``) through the score+top-k kernel
(``ops/kernels.py``, ``csrc/score_topk.cu``).
"""
