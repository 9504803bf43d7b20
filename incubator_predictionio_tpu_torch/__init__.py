"""PyTorch and CUDA port of incubator_predictionio_tpu, for NVIDIA Hopper.

The JAX package beside this one is the reference; this package imports
nothing from it and nothing of JAX. Its entry points run on the CUDA device
unless the caller passes ``device="cpu"``; a kernel wrapper given a CUDA
tensor launches its hand-written kernel (``csrc/``) or raises.

Ported so far: the recommendation template — ALS training through the
Gram+CG kernels (``ops/als.py``, ``ops/als_kernels.py``,
``csrc/als_solve.cu``) and serving over HTTP (``servers/
prediction_server.py``) through the score+top-k kernel (``ops/kernels.py``,
``csrc/score_topk.cu``); and the sequence engine (``models/sequence/``,
SASRec), served and trained with its long-window attention in the flash
kernel (``ops/attention_kernels.py``, ``csrc/flash_attention.cu``). Both
engines read their training events from the event store (``data/store.py``
over ``data/storage/``: memory, SQLite, local files), bucket ratings with a
native C++ builder (``native/``), and go from ``workflow.CoreWorkflow.
run_train`` to a checkpoint (``workflow/checkpoint.py``, the JAX package's
v2 format) and back through ``load_models`` to the prediction server. The
README quickstart's verbs run through the port's CLI (``python -m
incubator_predictionio_tpu_torch.cli.main``): ``app new``, the event server
(``servers/event_server.py``, with the native batch-body parse), ``import``
/ ``export``, ``build``, ``train``, ``deploy`` and ``undeploy``.
"""

__version__ = "0.1.0"
