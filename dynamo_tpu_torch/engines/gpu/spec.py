"""Speculative decoding policy — prompt-lookup (n-gram) proposals verified
in one [S, spec_k + 1]-token forward with rejection sampling; counterpart
of dynamo_tpu/engines/tpu/spec.py. The engine owns only the hooks
(engines/gpu/engine.py ``_spec_tick``); the verify lives in the runner
(``DeviceRunner.run_spec``: one CUDA graph a width bucket on the card).

Proposals come from a per-sequence n-gram index over prompt and
generation: the trailing ``spec_ngram`` tokens are looked up, and the
``spec_k`` tokens that followed their most recent earlier occurrence are
proposed. The verify scores every position (``llama.forward_paged(...,
all_logits=True)``) and ``ops/sampling.spec_verify_sample`` accepts the
run of proposals the target agrees with, then emits the corrected or bonus
token. A tick whose rows propose nothing, or that holds a row with
logprobs or logits processors, declines: the fused decode burst serves it.
Wins where outputs repeat their context (code edits, quotes from the
prompt); where nothing proposes it costs the depth-1 decode it forces.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

# Shared with the decode tick, so a verify's table widths are the decode
# bursts' pow2 buckets. No cycle: the engine imports this module lazily.
from dynamo_tpu_torch.engines.gpu.engine import table_width_bucket


class NgramSpecDecoder:
    """Engine-attached speculative decoder: its state lives on the
    sequences (``ngram_index``, ``ngram_upto``), its device program in the
    runner."""

    def __init__(self, engine: Any) -> None:
        self.e = engine

    def propose(self, seq: Any) -> List[int]:
        """Prompt-lookup proposal: index the tokens added since the last
        call, then continue from the most recent earlier occurrence of the
        trailing n-gram."""
        n = self.e.args.spec_ngram
        toks = seq.all_tokens
        # Register every n-gram ending at p, the final position excluded
        # (its continuation is what is being predicted).
        for p in range(max(seq.ngram_upto, n - 1), len(toks) - 1):
            seq.ngram_index[tuple(toks[p - n + 1 : p + 1])] = p + 1
        seq.ngram_upto = max(len(toks) - 1, 0)
        if len(toks) < n:
            return []
        cont = seq.ngram_index.get(tuple(toks[-n:]))
        if cont is None:
            return []
        return toks[cont : cont + self.e.args.spec_k]

    def eligible(self, active: List[Any]) -> bool:
        """Sampled rows are served by the rejection-sampling verify, so
        temperature does not gate a tick. A row with logprobs or logits
        processors keeps the tick on the fused path: the verify returns
        neither per-token logprobs nor processor state."""
        for s in active:
            if s.request.sampling.logprobs is not None:
                return False
            if self.e._uses_procs[s.slot]:
                return False
        return True

    async def tick(self) -> bool:
        """One verify over [next token + proposals] of every row. False when
        the tick is not eligible or nothing proposes (the fused burst of
        decode_steps tokens then serves it)."""
        e = self.e
        args = e.args
        # Proposals index all_tokens and the verify reads the host's pos and
        # tables, so the tick needs reconciled state: no burst in flight.
        await e._drain_inflight()
        occupied = [s for s in e._slots if s is not None]
        if not occupied:
            return True
        if not self.eligible(occupied):
            return False
        proposals: Dict[int, List[int]] = {s.slot: self.propose(s) for s in occupied}
        if not any(proposals.values()):
            return False

        C = args.spec_k + 1
        active = e._prepare_decode(C)
        if not active:
            return True
        S = args.max_num_seqs
        tokens = np.zeros((S, C), dtype=np.int64)
        lens = np.zeros(S, dtype=np.int32)
        max_blocks = 1
        for seq in active:
            slot = seq.slot
            # never speculate past the model-length cap
            room = args.max_model_len - int(e._pos[slot]) - 1
            prop = proposals.get(slot, [])
            prop = prop[: max(min(len(prop), room), 0)]
            proposals[slot] = prop
            tokens[slot, 0] = e._tok_mirror[slot]
            tokens[slot, 1 : 1 + len(prop)] = prop
            lens[slot] = 1 + len(prop)
            max_blocks = max(max_blocks, (int(e._pos[slot]) + C - 1) // args.block_size + 1)
        nb = table_width_bucket(max_blocks, args.max_blocks_per_seq)

        emitted_all, counts = await e._device(
            e._run_spec, tokens, e._pos.copy(), lens, e._block_tables[:, :nb].copy(),
            e._temp.copy(), e._topk.copy(), e._topp.copy(), e._salts.copy(),
            adapter_ids=e._adapter_ids.copy(),
        )
        e.steps += 1
        e.spec_ticks += 1
        # The verify held the card: the wait before the next fused dispatch
        # is not host-injected gap.
        e._t_last_ready = None
        for seq in list(active):
            if seq.slot < 0:
                continue  # finished by an earlier emit of this loop
            slot = seq.slot
            n = int(counts[slot])
            e.spec_proposed += len(proposals.get(slot, []))
            e.spec_accepted += n - 1
            e.spec_rows += 1
            e._emit_burst(seq, emitted_all[slot, :n])
            if seq.slot >= 0:
                # The verify advanced this slot outside the device carry:
                # the next fused burst resyncs its token and position.
                e._dirty_state.add(slot)
        return True
