"""dynamo_tpu_torch — the PyTorch/CUDA port of dynamo_tpu for NVIDIA Hopper.

The package mirrors the layout and names of ``dynamo_tpu`` so each module's
counterpart is found at the same path. It imports ``torch`` and never
``jax``, and nothing of ``dynamo_tpu``: where it needs one of that package's
framework-free modules (protocols, request context, block pool, block
hashes, the llm layer and its pipeline) it keeps its own copy. Nor does it
import a package the card's machine lacks: it reads ``tokenizer.json`` with
its own byte-level BPE (``llm/bpe.py``) and renders the default chat
template without jinja2.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on
the CPU every kernel wrapper runs its plain PyTorch version (the parity
tests use this), and on a CUDA tensor it launches its hand-written kernel
or raises.
"""

from dynamo_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
