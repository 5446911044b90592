"""PyTorch + CUDA port of the dynamo_tpu serving engine, for NVIDIA Hopper.

The package mirrors ``dynamo_tpu``'s module paths so every port module sits
at the same place as its counterpart. It imports neither ``jax`` nor
anything of ``dynamo_tpu``: where it needs code from a jax-free module of
that package it keeps its own copy. Plain tensor code is PyTorch; the one
TPU kernel on the serving path (ragged paged attention) is a hand-written
CUDA kernel under ``csrc/``, built at first use (``ops/_build.py``).

Entry points: the worker process ``python -m dynamo_tpu_torch.backends.torch``
and, in process, :func:`dynamo_tpu_torch.backends.torch.main.build_engine`.
"""
