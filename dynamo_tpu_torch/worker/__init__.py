"""Engine worker component (python -m dynamo_tpu_torch.worker) — the port's
counterpart of dynamo_tpu/worker/, serving TorchEngine.

Reference parity: components/src/dynamo/vllm/main.py — the engine worker
process: boot the engine, register the model card, serve the endpoint,
publish KV events and load stats.
"""
