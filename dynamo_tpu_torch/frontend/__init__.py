"""OpenAI HTTP frontend component (python -m dynamo_tpu_torch.frontend) — the
port's counterpart of dynamo_tpu/frontend/.

Reference parity: components/src/dynamo/frontend/main.py — one process
running the OpenAI server + discovery watcher + preprocessor + router.
"""
