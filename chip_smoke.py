#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dynamo_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. device — the card's name, and name + power limit from nvidia-smi.
2. build — compiles the port's CUDA sources (csrc/*.cu, one nvcc per
   source, started together) and prints nvcc's -Xptxas -v lines.
3. parity — each kernel against its plain PyTorch version on the card:
   paged attention at Qwen2.5-0.5B shapes (KH 2, G 7, D 64) and at
   Llama-3-8B shapes (KH 8, G 4, D 128); the fused decoder layer at a full
   Llama-3-8B layer (B 16, ragged contexts up to 1,600) and at miniatures
   of each epilogue variant (Qwen3, Gemma-2, Gemma-3, Qwen2, head_dim 256);
   the int8 lm-head untied at Llama-3-8B (V 128,256 x d 4,096) and tied at
   Qwen2.5-0.5B (V 151,936 x d 896). Every decode case of every phase is
   also checked with its keys split over 1, 2, 5 and 16 blocks, and two
   runs at the wrapper's own split count must agree bit for bit.
4. timing — each kernel, its plain version and, where one PyTorch call
   computes the same function, that call (a yardstick the port never
   calls), CUDA events over many launches after warm-up, beside the least
   time the card could take (bytes over 3.35 TB/s or flops over the bf16
   989 TFLOP/s, counted from the case's own data). A decode line names the
   key splits the wrapper chose (1: the one-pass kernel). Every chunk case
   also runs twice, bit for bit equal, and a chunk_cases line gathers the
   run's chunk times beside SDPA's.
5. engine — TorchEngine serving Qwen2.5-0.5B at full width (24 layers,
   random bf16 weights from a seed, the tied embedding scaled by
   QWEN_EMBED_SCALE so that attention decides the greedy stream) through
   generate(), at the engine's defaults: pipeline depth 2, each decode
   width bucket's burst one CUDA graph. Concurrent requests, a prompt long enough for chunked prefill, a
   prefix hit, and a greedy request repeated alone at the defaults and at
   depth 1 with eager bursts, which must give the same tokens. Kernel
   launch counts are zeroed just before and read just after (a graph
   replay adds its capture's launches); both paged-attention kernels must
   have launched. One stream is checked against a teacher-forced dense
   forward of the model.
6. profile — one decode burst of the same engine, eagerly and as a graph
   replay from the same pools and slot state: tokens, finite flags and
   every pool byte bit-equal. Then each mode under torch.profiler (a line
   a mode): host wall vs device busy time, kernels and host launch calls a
   step, and where the device time goes; a profile_graphs line sets the
   two modes side by side with the graphs captured, their capture time and
   replays, and whether the profiler sees the kernels inside a replay (if
   not, the replay's device time comes from CUDA events).
   Every engine phase below runs the same way, and every profile phase
   holds its burst eager against replayed and has its _graphs line.
7. engine_int8 — TorchEngine serving Llama-3-8B at full width (32 layers,
   random int8 weights from a seed) with the fused layer turned on by its
   gate, the same request set: the fused layer (32 launches a decode step),
   the int8 head and the chunk-attention kernel must have launched, and a
   stream is checked against a teacher-forced dense forward that takes the
   unfused layers.
   Its perf ledger (made anew before the engine) must hold only rows with
   path "fused", each with a roofline fraction in (0, 1.05] (a
   `perf_int8` line with them).
8. profile_int8 — one decode burst of the 8B engine: host wall vs device
   busy, idle share, device ops a step, the fused layer's share.
9. int8kv kernels — parity and timing of the int8-pool paged-attention
   kernels (D 64: KH 2, G 7; D 128: KH 8, G 4; window and softcap cases) and
   of the int8 weight-streaming product at the four Llama-3-8B weight shapes
   (M 16, 32, 64; with and without qeinsum's epilogue); at M 32 each shape
   and a layer's seven are also timed with a cold L2 (the calls rotate
   through weight copies exceeding 100 MB), and q/o at M 64 is a named
   case, warm and cold.
10. engine_int8kv — TorchEngine serving Llama-3-8B at full width with int8
   weights and int8 KV pools (the fused layer off by its gate): 32 slots,
   32 requests of 256 greedy tokens (prompts of 100-300 tokens, one of
   1,200, two sharing a 256-token prefix). Both int8-pool attention kernels,
   the int8 product and the int8 head must have launched, the first two at
   least once a layer a decode step (seven products a layer a step); a
   stream is checked against the teacher-forced dense forward.
11. profile_int8kv — one decode burst of that engine: host wall vs device
   busy, idle share, device ops a step, the shares of the int8 product and
   of int8 attention; the burst's launches are exactly 32 x 8 int8 decode
   attention, 7 x 32 x 8 int8 products and 8 heads, and none of any other
   kernel.
12. d256 kernels — parity of both bf16-pool attention kernels at head_dim
   256 in the Gemma-2 geometry (KH 4, G 2, softcap 50, window 4,096 at
   contexts of 4,000-6,600, window boundaries inside pages and tiles) and
   the Gemma-3 one (KH 1, G 4, window 512), and timing of each geometry's
   decode (B 16, C 1) and chunk (B 4, C 512) case.
13. engine_gemma2 — TorchEngine serving Gemma-2-2B at full width (26
   layers, d 2,304, V 256,000 tied, random bf16 weights from a seed, the
   embedding scaled by GEMMA2_EMBED_SCALE so that attention decides the
   greedy stream; max_model_len 8,192): the request set of the engine
   phase plus one
   prompt of 4,600 tokens, whose later chunks and decode steps cross the
   4,096-key window of the local layers. Both paged-attention kernels must
   have launched, decode at least once a layer a decode step, and no
   kernel of the int8 or fused paths; the 4,600-token stream is checked
   against the teacher-forced dense forward too.
14. profile_gemma2 — one decode burst of that engine: idle share, device
   ops a step, attention's share; the burst's launches are exactly 26 x 8
   decode attention and none of any other kernel.
15. gemma3 int8 kernels — parity of both int8-pool attention kernels at
   head_dim 256 in the Gemma-3 geometry (KH 1, G 4; window 512 with its
   boundary inside a page and a tile, and global layers at contexts of
   4,000-6,000; C·G > 64), of the tied int8 head at M 32 x 1,152 x 262,144
   and of the int8 product at a Gemma-3 layer's seven widths; timing of
   each (decode B 32, chunk B 4 x 512, at window 512 and global).
16. engine_gemma3_int8kv — TorchEngine serving Gemma-3-1B at full width (26
   layers, d 1,152, V 262,144 tied, random int8 weights from a seed, the
   embedding scaled by GEMMA3_EMBED_SCALE) with
   int8 KV pools (the fused layer off by its gate), max_model_len 8,192:
   the engine_int8kv request set plus one prompt of 4,600 tokens that
   crosses the 512-key window. Both int8-pool attention kernels, the int8
   product and the int8 head must have launched, decode attention at least
   once a layer a decode step and seven products a layer a step, and no
   bf16-pool or fused kernel; the 4,600-token stream is checked against the
   teacher-forced dense forward too.
17. profile_gemma3_int8kv — one decode burst of that engine: idle share,
   device ops a step, the shares of the int8 product and int8 attention;
   the burst's launches are exactly 26 x 8 int8 decode attention, 7 x 26 x
   8 int8 products and 8 heads, and none of any other kernel.

18. bs128 — parity of both paged-attention kernels at block size 128 over
   bf16 and int8 pools (D 128 at KH 8, G 4, and one D 64 case; window
   boundaries in a page's second 64-key tile, chunks across a page edge),
   and the bf16 kernels' times at _prof_attn.py's case and B 4 x C 512.
19. proto kernels — decode_packed (#6) and decode_bf16 (#7) against their
   plain version (decode_attention_bf16_ref) at _prof_attn.py's case (B 64,
   KH 8, G 4, D 128, block size 128, context 160), at B 13, at Gemma-2's
   heads (D 256, window 4,096, softcap 50, contexts 4,000-6,000) and at
   block size 16, each at the wrapper's key splits and at forced splits 1,
   2 and 16, and two runs bit for bit equal; ffn_int8 (#5) against
   ffn_int8_ref at 64 and 13 rows of Llama-3-8B's FFN (d 4,096, F 14,336).
   #6 and #7 timed at every case beside the plain version, SDPA and the
   bound (a proto_cases line), and at splits 1, 2, 4 and 8 at the first
   case (a proto_splits line); #5 beside its plain version, its bound and
   a library call.
20. prof_attn, prof_fused_ffn — the profiling entry points
   (tools/prof_attn.py at B 64, tools/prof_fused_ffn.py) with launch counts
   zeroed before and read after; the counts are exact.
21. prof_8b — tools/prof_8b.py's modes full (#1), floor, v2 (#6) and bf (#7)
   on the int8 Llama-3-8B weights of phase 10 (B 64, block size 128,
   context 160, 16 steps a call): ms a step and tok/s a mode, exact launch
   counts, finite logits, v2's and bf's first-step logits within
   LOGIT_LIMIT of full's.

22. fused_layer_phases — the fused layer's µs a phase at the Llama-3-8B
   case (tools/fused_layer_phases.py, a stamped copy of the kernel, the
   median of three runs) and the grid barriers a layer passes; a
   cluster_probe line says whether the card takes a cooperative launch with
   a thread block cluster dimension.

23. procs — logits processors and logprobs (ROADMAP A3) on phase 5's Qwen
   weights, through generate() on a fresh engine (procs_phase): twelve
   prompts served every row plain, then as a mixed batch (plain rows,
   repetition, presence and frequency penalties, a logit_bias ban of a
   row's own greedy tokens, a +100 forced token, min_p at temperature 0.8,
   logprobs 0, 5 and 20), then the mixed batch at depth 1 eagerly: the same
   tokens and logprobs at both, plain rows as in the all-plain run, no
   banned token, only the forced one, the logprob entries a token, the
   min_p filter, and the processed rows against a teacher-forced dense
   reference with the processors applied (QWEN_GAP_LIMIT and
   QWEN_PROCS_*). A procs_variants line: one burst in each graph variant
   (plain, logprobs, processors with logprobs), device ops and busy time a
   step, and the processors' cost a step.
24. gemma3 fused layer — the fused layer at a full Gemma-3-1B layer (32 rows
   at the engine's contexts and one at 4,600; a local layer with its
   512-key window and a global one) against its plain version (within
   tools/cases.MODEL_STEP_LIMIT bf16 steps, few values past one step),
   timed beside its bound, and its µs a phase at the local layer (a
   fused_layer_phases line).
25. engine_gemma3_int8 — TorchEngine serving Gemma-3-1B with int8 weights
   over bf16 pools (ROADMAP A1), the fused layer turned on by its gate: 26
   launches a decode step at D 256, G 4, KH 1, the bf16 chunk kernel past
   the first chunk and the tied int8 head at V 262,144, the int8-KV phase's
   request set with the 4,600-token prompt, the embedding scaled by
   GEMMA3_EMBED_SCALE, held to GEMMA3BF_*; no kernel of another path.
26. profile_gemma3_int8 — one decode burst of that engine; its launches are
   exactly 26 x 8 fused layers and 8 heads.
27. procs_gemma3_int8 — phase 23 on those weights (the fused burst, V
   262,144), held to GEMMA3BF_*, and its variants line.
28. engine_gemma3_int8_unfused, profile_gemma3_int8_unfused — the same
   request set and burst with use_megakernel=False (bf16-pool decode
   attention and seven int8 products a layer): the fused layer's yardstick.

29. pipeline — Qwen2.5-0.5B text in, text out through the OpenAI pipeline
   (build_local_pipeline: OpenAIPreprocessor with the default ChatML and the
   pure-Python byte-level BPE of tiny_tokenizer(), Backend's incremental
   detokenize and stop strings) over TorchEngine at the engine's defaults
   and its own random init (at init scale the tied head repeats its input
   token, so the streams stay inside the tokenizer's 383 ids): eight
   completions and chats of 100-300 tokens and one of ~1,200, 64 greedy
   tokens each, one with a stop string its stream reaches, one with
   logprobs, served at once. Each request's streamed ids must be what
   TorchEngine.generate() gives for the same PreprocessedRequest, its text
   tokenizer.decode(ids) (the stop request's cut before its stop string,
   finish_reason stop), its _prompt_tokens annotation its prompt's length,
   and both paged-attention kernels must have launched. The line: TTFT and
   ITL at the pipeline beside the engine's own for the same set (runs in
   the order engine, pipeline, pipeline, engine; ITL over the seven requests
   that run to 64 tokens at both), host ms to preprocess the set, host µs a
   token in the detokenize, ms to encode the ~1,200-token prompt.
30. cli_batch — `python -m dynamo_tpu_torch.cli run --input batch:FILE
   --model qwen2.5-0.5b --max-tokens 32` as a subprocess on a 4-line JSONL
   file: exit code 0, four JSONL lines (prompt, text, tokens, latency_s) and
   the `batch done:` summary.
31. http — the OpenAI HTTP frontend (HttpService on the standard-library
   server of http/web.py, 127.0.0.1) over phase 29's pipeline, requests
   sent by tools/sse_client.py from a process of its own: phase 29's set
   streamed with usage (runs in the order pipeline, http, http, pipeline,
   each from an empty prefix cache), then unary, n 2 and /v1/responses
   (unary and streamed) beside the pipeline on the same engine requests,
   the error cases (404, 400 x 3, 501), a stream the client leaves after
   three frames, /metrics. Each text is the pipeline's (a completion's
   frame for frame, the logprobs request's tokens its decoded ids), each
   stream ends in [DONE] with usage equal to the prompt's and the
   pipeline's token counts, the departed stream's slot frees before its
   max_tokens with 499 counted, /metrics parses, both paged-attention
   kernels launched. The line: TTFT and ITL over HTTP beside the
   pipeline's, host µs a frame in the service's SSE send (while serving,
   and alone with the engine idle), seconds a step of the phase.
32. cli_http — `python -m dynamo_tpu_torch.cli run --input http --model
   qwen2.5-0.5b --http-port 0` as a subprocess: its `http server on :PORT`
   line, a streamed chat and a unary completion, then SIGINT, after which
   it must end within 15 s.
33. runtime_tcp — the distributed runtime's planes across processes:
   `python -m dynamo_tpu_torch.discd` on free ports (discovery, the event
   broker with a durable log and replay), and this script again as a
   worker process (`--runtime-worker`, a test harness, not the worker
   main) that builds TorchEngine for Qwen2.5-0.5B at the engine's defaults
   and serves it on dynamo/backend/generate, with a control endpoint, through
   DistributedRuntime.from_settings() (discd, tcp, zmq). This process is the
   client: it resolves the worker through discd and streams phase 29's
   preprocessed set over TCP in the order in-process, tcp, tcp, in-process
   (the worker's engine itself, each run from an empty prefix cache, launch
   counts zeroed in the worker just before the first TCP run and read just
   after). Fails unless the TCP streams' ids are the in-process ones
   exactly, both paged-attention kernels launched in the worker, a cancel
   mid-stream frees the worker's slot (cold: the graphs of the lone
   stream's width buckets are captured inside it; then warm), the
   worker's run of events on one topic arrives in order and replays from
   the broker's log, and a killed worker surfaces StreamDisconnectedError. The line: TTFT and
   ITL over TCP beside the in-process figures, host µs a frame on each side
   (FrameWriter.send in the worker, FrameReader.recv's read and unpack
   here), events published to received in µs (p50, p99).
34. kv_router — KV-aware routing across two worker processes on the one
   card: discd with its broker, and phase 33's worker role twice
   (instances 1 and 2, `--kv-publish`: a KvEventPublisher on the engine's
   KV events, answering snapshot requests from pool.committed_view(), and a
   LoadPublisher on engine.stats() every KV_LOAD_INTERVAL_S). This process
   is the frontend: a RouterMode.KV client with KvRouter(runtime, "dynamo",
   "backend", block_size=16) started and attached. First the port's block
   hashes of a fixed 256-token list (block sizes 16 and 64, salt 0 and
   adapter_salt("lora-a")) must be HASH_CONSTANTS, xxh3-64's numbers. The
   traffic: KV_GROUPS groups of KV_GROUP_SIZE greedy requests of
   KV_MAX_TOKENS tokens, a group's requests sharing a 1,024-token prefix
   (64 blocks) and each adding a suffix of 32-200 tokens. A group's first
   request is sent alone among its group; once the router has applied the
   worker's KV events (wait_for_events) and sees that worker idle, the rest
   of the group is sent at once, and beside them the next group's first
   request. Launch counts are zeroed in both workers just before the
   KV-routed run and read just after. Fails unless every follower goes to
   its group's first worker with a predicted overlap of 64 blocks, the cold
   first requests land on both workers, each worker prefilled exactly the
   tokens the router predicted it would (prompt less 16 x overlap), the
   index holds exactly each worker's committed blocks (a `committed`
   control op), the scheduler's load view holds both workers, a fresh
   KvRouter rebuilds the same index from the workers' snapshots with no
   request, every stream equals the same request run in-process on worker
   1 (engine_run), and both paged-attention kernels launched in both
   workers. The same requests then go through a ROUND_ROBIN client from
   empty caches. The line: prefix-hit blocks, TTFT and ITL for each mode,
   host µs a 64-byte block hash and a find_best_match, events emitted to
   applied (µs p50, p99), events applied, the router's decisions by reason,
   both workers' launches.
35. mains — the deployment: discd, two `python -m dynamo_tpu_torch.worker
   --model qwen2.5-0.5b` processes (DYN_TPU_WORKER_ID 0x101 and 0x202, the
   JAX worker's defaults: the engine and weights of phase 29's pipeline;
   each through this script's `--mains-worker` role, which runs the
   worker's main() unchanged and writes its launch counts to a file) and
   `python -m dynamo_tpu_torch.frontend`, with the cluster env of
   tests/test_e2e_processes.py, load reports and liveness every
   MAINS_INTERVAL_S, dead after MAINS_DEAD_AFTER. This process is an HTTP
   client of the frontend and reads the workers' `stats` through their
   `control` endpoint. Fails unless: the model is on /v1/models after both
   workers print `worker serving`; phase 31's streamed set through the
   frontend gives phase 31's texts and finish reasons (a warm-up run
   pinned to each worker, then two runs from empty caches); a request pinned by `x-dynamo-worker` runs
   on that worker, the same text on each, and a client's `_pinned_worker`
   key steers nothing; each of MAINS_GROUPS groups' followers (sharing a
   1,024-token prefix) prefill on their leader's worker and hit the
   prefix's blocks; /clear_kv_blocks clears the workers' cached blocks,
   exactly; a 1,500-token greedy stream pinned to worker 0x202, which is SIGKILLed after
   MAINS_KILL_AFTER tokens ends with finish_reason length and no error
   frame, its tokens and their logprobs exactly those of the same request
   run unbroken on the survivor up to the tokens Migration carried, and
   after them exactly those of its witness, the request Migration built
   (the prompt with the carried tokens) run on the survivor (each sent to
   the survivor's generate endpoint from an empty cache), the frontend's
   /metrics counting 1 to the card's migration_limit migrations, liveness
   declaring the worker dead within MAINS_INTERVAL_S x (MAINS_DEAD_AFTER +
   1) and a new request running on the survivor; SIGTERM ends the survivor with exit 0 within
   its grace period and leaves its perf ledger's fingerprint file
   (DYN_TPU_PERF_FINGERPRINT_PATH, set for 0x101 alone) with a record of
   qwen2.5-0.5b on cuda, its instance leaves discd, the model leaves
   /v1/models (when the killed worker's lease lapses) and a request then
   gets a JSON error; SIGTERM ends the frontend with exit 0; both
   paged-attention kernels launched in each worker. The line: seconds to
   registration, latency_ms of the frontend's runs beside phase 31's, with
   the decode graphs the workers captured inside each measured run, the
   groups' hit blocks, kill to the next token (and the graphs the survivor
   captured during the long stream), detection, the tokens carried, where
   the unbroken run parts from the migrated stream and its logprob drift
   by span (printed, not held: its KV for the carried tokens was decoded,
   not re-prefilled, and rounds apart in bf16), SIGTERM exit, both
   workers' launches.
   Before the kill, the overload and trajectory planes (an `overload`
   line): two more frontend mains on the same discd, one with
   OVERLOAD_CAPS (4 streams, 4 waiters), one with OVERLOAD_SLA (a 0.5 ms
   p50 ITL SLA). Fails unless: a chat carrying TRACEPARENT through the
   default frontend is stitched on its /debug/trajectory/{trace_id} with
   the frontend's spans (http.chat_completions, overload.queue,
   router.select_worker) and the worker's (endpoint.serve, engine.queue,
   engine.prefill, engine.decode), queue, prefill and decode above zero,
   the phases summing to the root and no skew flagged; a request pinned to
   worker 0x101 with a 300 ms deadline, queued behind its 16 busy slots
   (a first pass of the 16 fillers captured their decode graphs),
   answers 504 with error_kind timeout ("deadline expired before
   admission") while all 16 still run, and the worker counts a deadline
   shed; OVERLOAD_BURST concurrent 256-token
   streams at the caps frontend give 8 whole streams, each the request
   run alone, and 16 typed 429s (queue_full, Retry-After 1) all answered
   before any admitted stream ended; at the SLA frontend, while a
   1,500-token stream runs and admissions keep coming, healthy ->
   brownout, a 512-token request clamped to 256, -> shed and a 503
   (brownout_shed, Retry-After 1) before that stream ends whole, both
   steps on /debug/overload and /metrics; both extra frontends end on
   SIGTERM with exit 0. The line: the stitched phases, the shed's
   answer time and the graphs captured meanwhile, the caps frontend's TTFT and ITL with the planes on, the
   SLA frontend's probes and p50 ITL.
   After it, the system part (a `system` line): worker 0x101
   (SYSTEM_WORKER) runs with `--system-port 0`. Fails unless: /live
   answers 200 right after `system server on :PORT` is printed, /readyz
   answers 503 until it answers 200 and 200 after `worker serving` (the
   line records whether a poll saw the 503); idle, /metrics carries the
   engine's gauges (decode_graphs and generated_tokens equal to the
   worker's stats), the overload, SLO, KV-reuse, fence and profiler
   families, dynamo_tpu_runtime_hbm_bytes for every ledger category and
   the device's bytes in use equal to the worker's CUDA allocator (its
   counts file); /debug/memory has the same categories, kv_cache the
   pools' storage bytes (NB + 1 blocks each), params the parameters'
   bytes, kv_pool_detail summing to kv_cache, device_bytes_in_use the
   allocator's and unaccounted_bytes >= 0 (printed); after an idle
   capture (the first sets CUPTI up), a /debug/profile capture of
   SYSTEM_PROFILE_S seconds, started while the worker decodes
   SYSTEM_PROFILE_LOAD streams and with a
   SYSTEM_PROFILE_PROMPT-token request sent inside it,
   stops by itself, no decode graph is captured inside it, its Chrome
   trace names a paged_attention kernel (the line records whether kernels
   replayed inside a CUDA graph show), /live answers within liveness's
   interval throughout the capture and its stop, liveness declares the
   worker dead no time, and the streams, paused while the stop parks the
   engine, end whole; /engine/clear_kv_blocks returns
   the worker's cached blocks and a `cleared` KV event from it reaches the
   event plane the frontend's router reads; a traced chat through the
   frontend shows on /debug/traces, /debug/requests[/{id}],
   /debug/trajectory[/{id}] and /debug/kvcache; /drain and /v1/loras
   answer 501 naming their ROADMAP items; `python -m dynamo_tpu_torch.cli
   observe kvcache|perf --port P` and `observe --port P` (the device
   plane) exit 0; the /debug/perf a scraper read while the ITL
   comparison's streams ran holds decode rows with samples, each roofline
   fraction in (0, 1.05] and equal within 1e-6 to its tok/s over the
   card's roofline (runtime/roofline.py) recomputed from the row's median
   occupancy and context; idle, /metrics' decode step count equals the
   worker's reaped bursts and /debug/compiles' captures its graphs. The
   line also records the µs a scrape of each SYSTEM_SCRAPED route takes
   while a stream runs, the ITL of SYSTEM_ITL_STREAMS streams with a
   scrape of them all every SYSTEM_SCRAPE_S against none (without, with,
   with, without): a record, not a limit; and the captures each of those
   runs held (printed too).
36. tick_retry — the engine's tick retry on the card: Qwen2.5-0.5B in
   this process (CUDA graphs, depth 2, embedding x QWEN_EMBED_SCALE) serves
   a greedy and a penalised stream (each after a run that captures its
   graphs), then each under a fault plan poisoning hit 2 of
   engine.tick.dispatch, then of engine.tick.reap, then with the runner's
   2nd decode_dispatch failing after its syncs and after its replay was
   enqueued: each must equal its unpoisoned stream. The line times all
   ten streams.
37. perf — the perf ledger's sentinel (``perf_phase``): three Qwen2.5-0.5B
   engines in this process on the same weights, each with a ledger of its
   own, PERF_KNOBS (evaluation interval, minimum samples) and a
   fingerprint file set through the environment, the same traffic: with
   graphs, storing its fingerprints at stop(); with graphs, loading them,
   no anomaly; eager (cuda_graphs=False, ~6x slower a burst), loading
   them: verdict regression with a step_regression anomaly, counted and
   in the perf ring. The line: each run's rows, verdicts and anomalies.

(18-20 run right after the Llama-3-8B kernels of phases 3-4, 22 right after
the fused layer's timing, 21 right after phase 11, 23 right after phase 6,
24-28 after phase 17, 29-37 right after phase 23.)
Then one JSON line {"kernels": [...]} for all ten kernels, nvidia-smi's
name and power limit, and last {"ok": true, "device": {...}}. Without a
CUDA device it exits 2 and prints no result.

    python3 chip_smoke.py --probe qwen:0.01,0.1:none,pos gemma3bf+procs:0.01:none,counts

runs only the named engine phases (qwen, gemma2, gemma3, gemma3bf,
gemma3bf_unfused; with +procs the processors phase after them), at each
embedding scale and with each fault of FAULTS planted (``probe``), without
limits: the calibration of the dense checks. It prints no result line.

    python3 chip_smoke.py --frame-probe

runs only the frame probe (``frame_probe``): the http phase's per-frame
host cost while serving, alone with the scheduler thread parked, and alone
with it dispatching, under two switch intervals. No result line either.
"""

from __future__ import annotations

import asyncio
import contextlib
import gc
import itertools
import json
import math
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

DEV = "cuda"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, same source
# |kernel - plain| <= ATOL + RTOL*|plain|: both read the same bf16 inputs and
# sum in f32 in different orders; the outputs round to bf16 (2^-8 relative),
# so they may differ by one rounding step. The outputs are softmax averages
# of N(0, 1) values over hundreds of keys, |out| ~ 0.03-0.06, where a bf16
# step is ~2.4e-4: ATOL is a few steps there, so an output off by a couple
# of percent fails.
ATOL, RTOL = 2e-3, 1e-2
# The Qwen and Gemma engine phases multiply their random embedding by a
# scale at which attention decides the greedy stream. With a tied head at
# init scale the input token's own row leads the logits, so the stream
# repeats its input (Qwen: 100 % of tokens; the Gemma reference lines read
# min_top2_margin 942-981) and a fault in attention or in the decode carry
# leaves the tokens as they were. Scales and limits were chosen from
# `chip_smoke.py --probe ...` on the card (PERF.md), which runs a phase at
# given scales with faults planted in memory (FAULTS), after a full run had
# failed the Gemma limits first stated here (Gemma-2 at 0.01 still
# repeated 98 % of its inputs; Gemma-3's share of tokens that are the
# reference's argmax read 0.039 against a floor of 0.25).
#
# Qwen2.5-0.5B (bf16, d 896): at 0.01, 11 % of tokens repeat their input
# and the engine took the reference's argmax at 64 of 64 tokens (logits'
# std 0.30; the request's batched and alone runs part by 0.0078, one bf16
# step). With the carry's pos held back (fault "pos") the worst token
# reads 0.93 below the argmax (median rank 28); at 0.3 the same fault read
# 0 (98 % repeats). The limit, 0.1, lies between the two.
QWEN_EMBED_SCALE = 0.01
QWEN_GAP_LIMIT = 0.1
# Gemma-2-2B (bf16, d 2,304): at 0.0025 about half the tokens are not the
# input token (0.47-0.56 repeat), the logits spread with std 0.12, and the
# engine took the reference's argmax at 127 of 128 tokens, at most 0.0039
# below it (batched and alone runs parted once, 0.0078 apart). The limit,
# 0.03, is a quarter of a std and eight times that: a token off by more
# fails, and most steps' top two lie closer (min_top2_margin 0).
GEMMA2_EMBED_SCALE = 0.0025
GEMMA2_GAP_LIMIT = 0.03
# Gemma-3-1B (int8 weights and KV, d 1,152): at every scale tried the
# model with random weights is chaotic. The engine's own runs of one
# request, batched and alone (prefill at other shapes, last bits apart),
# part within the first three tokens by 0.08-1.07 logits, so no reference
# that is not bit-identical holds its argmax (6-51 of 256 tokens) or its
# worst token (up to 0.85 of a random token's gap; the largest rank of a
# sound stream's token reaches 47,059). What does hold is the rank of the
# engine's tokens among the reference's 262,144 logits: median 13-368 at
# every scale, where a token chosen without the model gives ~131,000, and
# the mean gap: 0.17-0.35 of a random token's. At 0.01 (1 % of tokens
# repeat their input) the planted faults read, on the 4,600-token stream:
# window off in decode 112,684 and 0.96, pos held back 109,157 and 0.95,
# int8 KV scales 5 % high 7,031 and 0.58 (on the 226-token stream, inside
# the window, 194 and 0.31: not caught). Each limit lies between the
# sound runs' largest and the faults' smallest reading: a median rank of
# at most 1,600 (their geometric middle) and a mean gap of at most 0.46 of
# a random token's (their middle). No limit is set on a single token.
GEMMA3_EMBED_SCALE = 0.01
GEMMA3_MEDIAN_RANK_LIMIT = 1600
GEMMA3_MEAN_GAP_SHARE = 0.46
# Gemma-3-1B with int8 weights over bf16 pools (the fused layer at D 256):
# as chaotic as over int8 KV. `--probe gemma3bf:0.01:none,fused_window,
# fused_rope gemma3bf_unfused:0.01:none` read, on the 226- / 4,600-token
# streams (exact argmax, max and mean gap as a share of a random token's,
# median rank): sound 94 / 13 of 256, max 0.79 / 1.37, 0.065 / 0.27, 2 /
# 111; the same weights with the fused layer off 184 / 23, 0.22 / 1.22,
# 0.011 / 0.24, 0 / 59; the window dropped in the fused layer (inside the
# window on the short stream: unmoved there) 0.92, 92,840 on the long one;
# the global rope table on the local layers 0.84 / 0.93, 59,425 / 93,040.
# The sound runs' single tokens trail the argmax by up to 1.37, so no
# per-token limit; the int8-KV phase's limits lie between the sound
# readings and the faults' and hold here too: median rank at most 1,600,
# mean gap at most 0.46 of a random token's.
GEMMA3BF_GAP_LIMIT = None
GEMMA3BF_MEDIAN_RANK_LIMIT = GEMMA3_MEDIAN_RANK_LIMIT
GEMMA3BF_MEAN_GAP_SHARE = GEMMA3_MEAN_GAP_SHARE
# The processors phase (procs_phase): its processed rows (9 x 64 tokens)
# against the teacher-forced dense reference with the processors applied.
# `--probe qwen+procs:0.01:none,counts gemma3bf+procs:0.01:none,counts`
# read (sound / counts never recorded): Qwen max gap 0.0156 / 1.5, largest
# logprob difference 0.0156 / 10.2, smallest top-N overlap 0.6 / 0.2;
# Gemma-3 over bf16 pools max gap 0.375 / 20.9, mean gap 0.017 / 0.59 of
# a random token's, median rank 0 / 0, logprob difference 0.41 / 10.98,
# top-N overlap 0 / 0 (its top-5 past the first few lie within its logit
# noise: not held). Qwen is held to QWEN_GAP_LIMIT, a logprob difference of
# 0.1 and an overlap of 0.4; Gemma-3 to a gap of 2.0, a mean gap of 0.3 of
# a random token's and a logprob difference of 2.0, each between the two.
QWEN_PROCS_LOGPROB_LIMIT = 0.1
QWEN_PROCS_TOP_OVERLAP = 0.4
GEMMA3BF_PROCS_GAP_LIMIT = 2.0
GEMMA3BF_PROCS_MEAN_GAP_SHARE = 0.3
GEMMA3BF_PROCS_LOGPROB_LIMIT = 2.0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


# -- kernels --------------------------------------------------------------


def make_case(torch, B, C, starts, clens, seed, H=14, KH=2, D=64, BS=16):
    from dynamo_tpu_torch.tools.cases import attention_case

    return attention_case(B, C, starts, clens, seed, device=DEV, H=H, KH=KH, D=D, BS=BS)


def run_kernel(kernels, kind, case, window=0, cap=0.0):
    if kind == "decode":
        return kernels.paged_attention_decode(
            case["q"], case["k"], case["v"], case["tables"], case["start"],
            window=window, logit_cap=cap,
        )
    return kernels.paged_attention_chunk(
        case["q"], case["k"], case["v"], case["tables"], case["start"], case["clens"],
        window=window, logit_cap=cap,
    )


def run_plain(attention, case, window=0, cap=0.0):
    return attention.paged_attention_ref(
        case["q"], case["k"], case["v"], case["tables"], case["start"], case["clens"],
        window=window, logit_cap=cap,
    )


def compare(torch, out, ref, clens):
    worst = 0.0
    for b, n in enumerate(clens):  # rows past chunk_lens are padding
        a = out[b, :n].float()
        r = ref[b, :n].float()
        if not torch.isfinite(a).all():
            return float("inf"), False
        err = (a - r).abs()
        worst = max(worst, float(err.max()))
        if bool((err > ATOL + RTOL * r.abs()).any()):
            return worst, False
    return worst, True


def time_ms(torch, fn, iters):
    """Device ms of one call: tools/timing.queued_ms (CUDA events around
    ``iters`` calls queued behind a sleep kernel that outlasts the host's
    queueing)."""
    from dynamo_tpu_torch.tools.timing import queued_ms

    return queued_ms(fn, iters)


def bound(case, window=0):
    """Least time for one call: bytes of the live rows of q and out (rows
    past chunk_lens are padding the kernel need not read or write), the
    live K/V rows (int8 pools: one byte a value and a float32 scale a token
    and head), the table entries and per-row scalars, each moved once;
    flops 4·D per visible (row, key). All counted from this case's data."""
    from dynamo_tpu_torch.ops.kv_quant import pool_values

    starts = case["start"].tolist()
    clens = case["clens"].tolist()
    B, _, H, D = case["q"].shape
    BS, KH = pool_values(case["k"]).shape[1:3]
    kv_bytes = D + 4 if isinstance(case["k"], dict) else 2 * D  # a token's row of one head
    live_tokens = 0
    pages = 0
    flops = 0
    for s, n in zip(starts, clens):
        last = s + max(n, 1) - 1
        first = max(s - window + 1, 0) if window > 0 else 0
        live_tokens += last - first + 1
        pages += last // BS - first // BS + 1
        for c in range(n):
            lo = max(s + c - window + 1, 0) if window > 0 else 0
            flops += 4 * D * H * (s + c - lo + 1)
    nbytes = (
        2 * sum(clens) * H * D * 2  # live q rows in, out
        + 2 * live_tokens * KH * kv_bytes  # K and V rows
        + pages * 4 + 2 * B * 4  # table entries, start, chunk_lens
    )
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def library_call(torch, case, window=0):
    """SDPA over pre-gathered dense K/V with GQA and the causal (and
    ``window``) mask: gathered (and int8 pools dequantized to bf16) once
    outside the timed call."""
    import torch.nn.functional as F

    from dynamo_tpu_torch.ops.kv_quant import dequantize_pool

    q, tables = case["q"], case["tables"].long()
    B, C, _, D = q.shape
    k_pool, v_pool = dequantize_pool(case["k"]), dequantize_pool(case["v"])
    BS, KH = k_pool.shape[1:3]
    T = tables.shape[1] * BS
    k = k_pool[tables].reshape(B, T, KH, D).transpose(1, 2).contiguous()
    v = v_pool[tables].reshape(B, T, KH, D).transpose(1, 2).contiguous()
    qh = q.transpose(1, 2).contiguous()
    t = torch.arange(T, device=DEV)[None, None, :]
    limit = case["start"].long()[:, None, None] + torch.arange(C, device=DEV)[None, :, None]
    mask = t <= limit
    if window > 0:
        mask = mask & (t > limit - window)
    mask = mask[:, None]  # [B, 1, C, T]

    def call():
        return F.scaled_dot_product_attention(qh, k, v, attn_mask=mask, enable_gqa=True)

    return call


def kernel_phases(torch):
    g = torch.Generator().manual_seed(7)
    ragged = lambda n, hi: torch.randint(0, hi + 1, (n,), generator=g).tolist()  # noqa: E731
    dec1 = make_case(torch, 16, 1, ragged(16, 1500), [1] * 16, seed=1)
    dec5 = make_case(torch, 16, 5, ragged(16, 1500), [5] * 16, seed=2)
    chunk = make_case(torch, 4, 512, [512] * 4, [512, 300, 37, 1], seed=3)
    cases = [
        ("paged_attention_decode", "decode", "B16 C1 ragged starts", dec1, 0, 0.0),
        ("paged_attention_decode", "decode", "B16 C5 ragged starts", dec5, 0, 0.0),
        ("paged_attention_decode", "decode", "B4 C3 window 100 softcap 30",
         make_case(torch, 4, 3, [0, 90, 400, 1000], [3] * 4, seed=4), 100, 30.0),
        ("paged_attention_decode", "decode", "B8 C1 window 300 softcap 30",
         make_case(torch, 8, 1, ragged(8, 1500), [1] * 8, seed=6), 300, 30.0),
        ("paged_attention_chunk", "chunk", "B4 C512 start 512 ragged lens", chunk, 0, 0.0),
        ("paged_attention_chunk", "chunk", "B2 C40 window 64 softcap 20",
         make_case(torch, 2, 40, [200, 37], [40, 17], seed=5), 64, 20.0),
    ]
    worst = attention_parity(torch, cases)
    reset_counts()  # parity launches do not count
    timed = attention_timing(torch, dec1, chunk, label="qwen2.5-0.5b D64")
    reset_counts()
    return worst, timed


def attention_parity(torch, cases) -> dict:
    """Each (kernel, kind, label, case, window, softcap) against the plain
    version, the decode cases also at forced key splits (split_parity);
    fails on the first disagreement. Returns the worst error of each
    kernel."""
    from dynamo_tpu_torch.ops import attention
    from dynamo_tpu_torch.ops.cuda import paged_attention as kernels

    worst = {}
    for name, kind, label, case, win, cap in cases:
        out = run_kernel(kernels, kind, case, win, cap)
        ref = run_plain(attention, case, win, cap)
        torch.cuda.synchronize()
        err, ok = compare(torch, out, ref, case["clens"].tolist())
        emit({"phase": "parity", "kernel": name, "case": label, "max_abs_err": err,
              "tol": f"{ATOL} + {RTOL}*|plain|", "ok": ok})
        if not ok:
            fail(f"{name} ({label}) disagrees with its plain version: max abs err {err}")
        worst[name] = max(worst.get(name, 0.0), err)
        if kind == "chunk":  # sums in a fixed order: two runs give the same bits
            same = torch.equal(out, run_kernel(kernels, kind, case, win, cap))
            emit({"phase": "parity", "kernel": name, "case": f"{label}, two runs",
                  "bit_equal": same, "ok": same})
            if not same:
                fail(f"{name} ({label}): two runs differ")
    for name, err in split_parity(torch, cases).items():
        worst[name] = max(worst[name], err)
    return worst


# Every chunk-kernel timing of the run, for the chunk_cases line.
CHUNK_TIMES = []


def attention_timing(torch, dec, chunk, suffix="", window=0, cap=0.0, label="") -> dict:
    """The decode kernel on ``dec`` and the chunk kernel on ``chunk``: kernel,
    plain and SDPA times beside the bound, at the cases' ``window`` and
    softcap. ``suffix``: "_int8" for the int8-pool variants (the cases hold
    int8 pools). SDPA has no softcap: with ``cap`` it is timed without one."""
    from dynamo_tpu_torch.ops import attention
    from dynamo_tpu_torch.ops.cuda import paged_attention as kernels

    timed = {}
    smi = smi_line()
    for name, kind, case in ((f"paged_attention_decode{suffix}", "decode", dec),
                             (f"paged_attention_chunk{suffix}", "chunk", chunk)):
        ms = time_ms(torch, lambda: run_kernel(kernels, kind, case, window, cap), 50)
        plain_ms = time_ms(torch, lambda: run_plain(attention, case, window, cap), 10)
        library_ms = time_ms(torch, library_call(torch, case, window), 50)
        bound_ms, bound_by = bound(case, window)
        timed[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                           bound_ms=bound_ms, bound_by=bound_by)
        # the decode kernel's key splits (1: the one-pass kernel, no combine)
        extra = {"splits": kernels.split_count(case["q"], case["k"])} if kind == "decode" else {}
        if kind == "chunk":
            CHUNK_TIMES.append(dict(kernel=name, case=label, **timed[name],
                                    sdpa_ratio=timed[name]["ms"] / timed[name]["library_ms"]))
        emit({"phase": "timing", "kernel": name, "case": label, "shape": list(case["q"].shape),
              "pool": "int8" if isinstance(case["k"], dict) else "bf16", "window": window,
              "softcap": cap, **extra, **timed[name],
              "library": "SDPA" + (" without the softcap" if cap else ""), "card": smi})
    return timed


def split_parity(torch, cases) -> dict:
    """The decode kernel at forced key splits 1, 2, 5 and 16 on each decode
    (kernel, kind, label, case, window, softcap) of ``cases``, against the
    plain version under the same limit, and two runs at the split count the
    wrapper chooses bit for bit equal (the combine adds the splits in a
    fixed order); fails on the first disagreement. Returns the worst error
    of each kernel."""
    from dynamo_tpu_torch.ops import attention
    from dynamo_tpu_torch.ops.cuda import paged_attention as kernels

    worst = {}
    for name, kind, label, case, win, cap in cases:
        if kind != "decode":
            continue
        ref = run_plain(attention, case, win, cap)
        args = (case["q"], case["k"], case["v"], case["tables"], case["start"])
        for splits in (1, 2, 5, 16):
            out = kernels.paged_attention_decode(*args, window=win, logit_cap=cap, splits=splits)
            torch.cuda.synchronize()
            err, ok = compare(torch, out, ref, case["clens"].tolist())
            emit({"phase": "parity", "kernel": name, "case": f"{label}, splits {splits}",
                  "max_abs_err": err, "tol": f"{ATOL} + {RTOL}*|plain|", "ok": ok})
            if not ok:
                fail(f"{name} ({label}) at {splits} splits disagrees with its plain version: "
                     f"max abs err {err}")
            worst[name] = max(worst.get(name, 0.0), err)
        a = kernels.paged_attention_decode(*args, window=win, logit_cap=cap)
        b = kernels.paged_attention_decode(*args, window=win, logit_cap=cap)
        same = torch.equal(a, b)
        emit({"phase": "parity", "kernel": name, "case": f"{label}, two runs",
              "splits": kernels.split_count(case["q"], case["k"]), "bit_equal": same, "ok": same})
        if not same:
            fail(f"{name} ({label}): two runs differ")
    return worst


# -- Llama-3-8B int8 kernels ----------------------------------------------

# The fused layer against its plain version: at most one bf16 step apart
# (tools.cases.bf16_steps <= 1). Both sum bf16 x int8 products in f32, in
# different orders, and round the same intermediates (h, attn, gu,
# k_new/v_new) to bf16, so a sum on a rounding boundary may land one step
# away.
STEP_LIMIT = 1.0


def layer_bound(case, call):
    """Least time for one fused layer: every int8 weight byte, scale and
    norm vector read once, x, cos/sin, the live history K/V rows (keys in
    [wlo, min(start, pages·BS)) of each row's table) and its table entries
    read once, x_out/k_new/v_new written once; flops 2·B per weight plus
    4·H·D per visible (row, key) including the current token, at the bf16
    tensor-core peak."""
    B, d, H, KH, D, F, BS = case["shape"]
    P = case["tables"].shape[1]
    window = call.get("window", 0)
    n_w = d * H * D + 2 * d * KH * D + H * D * d + 3 * d * F
    n_s = H * D + 2 * KH * D + 2 * d + 2 * F
    keys, pages = 0, 0
    for s in case["start"].tolist():
        kend = min(s, min((s + BS - 1) // BS, P) * BS)
        wlo = max(s - window + 1, 0) if window > 0 else 0
        if kend > wlo:
            keys += kend - wlo
            pages += (kend - 1) // BS - wlo // BS + 1
    nbytes = (n_w + 4 * n_s + 2 * 2 * d + 2 * B * d * 2 + 2 * B * D * 4
              + 2 * keys * KH * D * 2 + pages * 4 + 2 * B * 4 + 2 * B * KH * D * 2)
    flops = 2 * B * n_w + 4 * H * D * (keys + B)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def head_bound(M, K, V):
    """Least time for the int8 head: codes, scales and x read once, f32
    logits written once; 2·M·K·V flops at the bf16 peak."""
    t_bytes = (K * V + 4 * V + 2 * M * K + 4 * M * V) / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * M * K * V / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def int8_kernel_phases(torch):
    """Parity and timing at Llama-3-8B shapes: paged attention at D 128, the
    fused layer (and its epilogue variants), the int8 head."""
    from dynamo_tpu_torch.ops.cuda import fused_layer as fk
    from dynamo_tpu_torch.ops.fused_layer import fused_decoder_layer_ref
    from dynamo_tpu_torch.tools.cases import LAYER_CASES, bf16_steps, make_layer_case, run_layer

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    g = torch.Generator().manual_seed(8)
    ragged = lambda n, hi: torch.randint(0, hi + 1, (n,), generator=g).tolist()  # noqa: E731
    wide = dict(H=32, KH=8, D=128)
    dec = make_case(torch, 16, 1, ragged(16, 1500), [1] * 16, seed=31, **wide)
    chunk = make_case(torch, 4, 512, [512] * 4, [512, 300, 37, 1], seed=33, **wide)
    worst = attention_parity(torch, [
        ("paged_attention_decode", "decode", "D128 B16 C1 ragged starts", dec, 0, 0.0),
        ("paged_attention_decode", "decode", "D128 B4 C2 window 100 softcap 30",
         make_case(torch, 4, 2, [0, 90, 400, 1000], [2] * 4, seed=32, **wide), 100, 30.0),
        ("paged_attention_chunk", "chunk", "D128 B4 C512 start 512 ragged lens", chunk, 0, 0.0),
    ])

    worst["fused_decoder_layer"] = 0.0
    cases = {}
    for label in LAYER_CASES:
        c, call = make_layer_case(label, DEV)
        cases[label] = (c, call)
        got = run_layer(fk.fused_decoder_layer, c, call)
        again = run_layer(fk.fused_decoder_layer, c, call)
        ref = run_layer(fused_decoder_layer_ref, c, call)
        torch.cuda.synchronize()
        st = {n: bf16_steps(a, r) for n, a, r in zip(("x_out", "k_new", "v_new"), got, ref)}
        err = max(float((a.float() - r.float()).abs().max()) for a, r in zip(got, ref))
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        finite = all(bool(torch.isfinite(a.float()).all()) for a in got)
        ok = same and finite and max(st.values()) <= STEP_LIMIT
        emit({"phase": "parity", "kernel": "fused_decoder_layer", "case": label,
              "max_abs_err": err, "bf16_steps": st, "repeatable": same,
              "tol": f"{STEP_LIMIT} bf16 step", "ok": ok})
        if not ok:
            fail(f"fused_decoder_layer ({label}) disagrees with its plain version: {st}, "
                 f"repeatable={same}, finite={finite}")
        worst["fused_decoder_layer"] = max(worst["fused_decoder_layer"], err)

    heads = {label: head_case(torch, tied, M, K, V)
             for label, tied, M, K, V in (("llama3-8b untied M16", False, 16, 4096, 128256),
                                          ("qwen2.5-0.5b tied M16", True, 16, 896, 151936))}
    worst["lm_head_int8"] = max(head_parity(torch, label, *h) for label, h in heads.items())
    reset_counts()  # parity launches do not count

    attention_timing(torch, dec, chunk, label="llama-3-8b D128")  # printed, not in the kernels line
    timed = {}
    smi = smi_line()
    c, call = cases["llama3-8b B16"]
    ms = time_ms(torch, lambda: run_layer(fk.fused_decoder_layer, c, call), 50)
    plain_ms = time_ms(torch, lambda: run_layer(fused_decoder_layer_ref, c, call), 5)
    bound_ms, bound_by = layer_bound(c, call)
    timed["fused_decoder_layer"] = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                                        bound_ms=bound_ms, bound_by=bound_by)
    emit({"phase": "timing", "kernel": "fused_decoder_layer", "case": "llama3-8b B16",
          **timed["fused_decoder_layer"], "library": "none: no one PyTorch call computes a layer",
          "card": smi})
    fused_layer_phases_line(torch, smi)

    timed["lm_head_int8"] = head_timing(torch, "llama3-8b untied M16",
                                        *heads["llama3-8b untied M16"])
    reset_counts()
    return worst, timed


def fused_layer_phases_line(torch, smi, case="llama3-8b B16", cluster_probe=True) -> None:
    """The fused layer's µs a phase at a layer case (the Llama-3-8B B 16 one
    by default; tools/fused_layer_phases.py: a stamped copy of the kernel;
    the median of three runs a phase), the grid barriers a layer passes,
    and whether the card takes a cooperative launch with a thread block
    cluster dimension (ops/cuda/fused_layer.cluster_probe). Timed launches
    of the stamped copy do not count."""
    import statistics

    from dynamo_tpu_torch.ops.cuda import fused_layer as fk
    from dynamo_tpu_torch.tools import fused_layer_phases

    runs = fused_layer_phases.run(case, 3)
    us = {name: statistics.median(r["us"][name] for r in runs) for name in runs[0]["us"]}
    emit({"phase": "fused_layer_phases", "case": case, "us": us,
          "total_us": statistics.median(r["total_us"] for r in runs),
          "barriers": runs[0]["barriers"], "card": smi})
    if cluster_probe:
        emit({"phase": "cluster_probe", **fk.cluster_probe(DEV), "card": smi})
    reset_counts()


def head_case(torch, tied, M, K, V):
    """(x [M, K] bf16, int8 head, tied): untied codes [K, V] with scales
    [1, V], or tied codes [V, K] (an embedding table) with one scale a
    vocab row."""
    from dynamo_tpu_torch.tools.cases import q8_weight

    hg = torch.Generator(device=DEV).manual_seed(K)
    w = q8_weight(hg, V, K, DEV) if tied else q8_weight(hg, K, V, DEV)
    if tied:  # one scale per vocab row
        w["s"] = (torch.rand(V, 1, generator=hg, device=DEV) + 0.5) * (K**-0.5 / 73.3)
    x = torch.randn(M, K, generator=hg, device=DEV).to(torch.bfloat16)
    return x, w, tied


def head_parity(torch, label, x, w, tied) -> float:
    """The int8 head against its plain version; fails beyond one bf16 step
    of the product. Returns the largest error."""
    from dynamo_tpu_torch.ops.cuda import lm_head as hk
    from dynamo_tpu_torch.ops.quant import lm_head_ref

    out = hk.lm_head_int8(x, w["q8"], w["s"], tied=tied)
    ref = lm_head_ref(x, w, tied=tied)
    torch.cuda.synchronize()
    err = (out - ref).abs()
    ok = bool((err <= 2.0**-7 * ref.abs() + 1e-5 * ref.abs().max()).all())
    emit({"phase": "parity", "kernel": "lm_head_int8", "case": label,
          "max_abs_err": float(err.max()), "tol": "2^-7*|plain| + 1e-5*max|plain|", "ok": ok})
    if not ok:
        fail(f"lm_head_int8 ({label}) disagrees with its plain version: {float(err.max())}")
    return float(err.max())


def head_timing(torch, label, x, w, tied) -> dict:
    """The int8 head, its plain version and torch.matmul over the
    bf16-dequantised head (dequantised outside the timed call)."""
    from dynamo_tpu_torch.ops.cuda import lm_head as hk
    from dynamo_tpu_torch.ops.quant import lm_head_ref

    dq = (w["q8"].float() * w["s"]).to(torch.bfloat16)
    if tied:
        dq = dq.t()  # [K, V]: the product torch.matmul takes for x @ embed.T
    ms = time_ms(torch, lambda: hk.lm_head_int8(x, w["q8"], w["s"], tied=tied), 50)
    plain_ms = time_ms(torch, lambda: lm_head_ref(x, w, tied=tied), 10)
    library_ms = time_ms(torch, lambda: torch.matmul(x, dq), 50)
    del dq
    bound_ms, bound_by = head_bound(*x.shape, w["q8"].shape[0 if tied else 1])
    timed = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                 bound_by=bound_by)
    emit({"phase": "timing", "kernel": "lm_head_int8", "case": label, **timed,
          "library": "torch.matmul over the bf16-dequantised head", "card": smi_line()})
    return timed


# -- int8 KV: int8-pool attention and the int8 weight-streaming product -----


def matmul_bound(M, K, N):
    """Least time for one epilogue-form product: codes, scales and x read
    once, bf16 out written once; 2·M·K·N flops at the bf16 peak."""
    t_bytes = (K * N + 4 * N + 2 * M * K + 2 * M * N) / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * M * K * N / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def int8kv_kernel_phases(torch):
    """Parity and timing of the int8-pool attention kernels and of the int8
    product. Returns (worst errors, timings) of the three kernels; the
    product's timing is one Llama-3-8B layer's seven products at M 32 (the
    engine_int8kv phase's slots), summed."""
    from dynamo_tpu_torch.tools.cases import (
        INT8_ATTENTION_CASES, MATMUL_SHAPES, make_int8_attention_case,
    )

    cases = {label: make_int8_attention_case(label, DEV) for label in INT8_ATTENTION_CASES}
    # The limit of bf16 pools: kernel and plain version read the same codes
    # and scales and fold the scales in at the same points.
    worst = attention_parity(torch, [(name, kind, label, case, win, cap)
                                     for label, (name, kind, case, win, cap) in cases.items()])

    worst["int8_matmul"] = matmul_parity(torch, MATMUL_SHAPES, (16, 32, 64))
    reset_counts()  # parity launches do not count

    timed = attention_timing(torch, cases["int8 D128 B32 C1 ragged starts"][2],
                             cases["int8 D128 B4 C512 start 512 ragged lens"][2], "_int8",
                             label="llama-3-8b int8 D128")
    timed["int8_matmul"] = matmul_layer_timing(torch, MATMUL_SHAPES, (16, 32, 64),
                                               "one Llama-3-8B layer's seven products, M 32")
    # q/o at prof_8b's 64 rows, warm and cold
    emit({"phase": "timing", "kernel": "int8_matmul", "case": "q/o 4096x4096 M64 (prof_8b rows)",
          **matmul_times(torch, 4096, 4096, 64, cold=True), "weight_bytes": 4096 * 4096,
          "library": "torch.matmul over the bf16-dequantised weight", "card": smi_line()})
    reset_counts()
    return worst, timed


def matmul_parity(torch, shapes, Ms) -> float:
    """The int8 product, raw and with qeinsum's epilogue, against its plain
    version at each weight shape of ``shapes`` and row count of ``Ms``;
    fails on the first disagreement. Returns the largest error."""
    from dynamo_tpu_torch.ops.cuda import int8_matmul as mk
    from dynamo_tpu_torch.ops.quant import int8_matmul_ref
    from dynamo_tpu_torch.tools.cases import RAW_RTOL, epilogue_ok, matmul_case, raw_product_ok

    worst = 0.0
    for label, (K, N, _) in shapes.items():
        for M in Ms:
            c = matmul_case(M, K, N, device=DEV)
            raw = mk.int8_matmul(c["x"], c["q8"])
            out = mk.int8_matmul(c["x"], c["q8"], c["s"])
            again = mk.int8_matmul(c["x"], c["q8"], c["s"])
            raw_ref = int8_matmul_ref(c["x"], c["q8"])
            ref = int8_matmul_ref(c["x"], c["q8"], c["s"])
            torch.cuda.synchronize()
            raw_err, raw_ok = raw_product_ok(raw, c["x"], c["q8"], raw_ref)
            err, step_ok = epilogue_ok(out, raw, raw_ref, c["x"], c["q8"], c["s"], ref)
            same = torch.equal(out, again)
            ok = raw_ok and step_ok and same and bool(torch.isfinite(raw).all())
            emit({"phase": "parity", "kernel": "int8_matmul", "case": f"{label} M{M}",
                  "raw_max_abs_err": raw_err, "max_abs_err": err, "repeatable": same,
                  "tol": f"raw: {RAW_RTOL}*(|x|@|w|); epilogue: bf16(bf16(raw)*s) exactly, "
                         "and one bf16 step of the product from the plain version's",
                  "ok": ok})
            if not ok:
                fail(f"int8_matmul ({label} M{M}) disagrees with its plain version: raw {raw_ok}, "
                     f"epilogue {step_ok}, repeatable {same}")
            worst = max(worst, err, raw_err)
    return worst


# Weight bytes a cold-L2 timing rotates through: twice the H100's 50 MB L2.
COLD_BYTES = 100 * 2**20


def matmul_times(torch, K, N, M, cold) -> dict:
    """The int8 product (epilogue form), its plain version and torch.matmul
    over the bf16-dequantised weight at one shape, warm (the same weight on
    every call); with ``cold`` also the kernel and torch.matmul rotating
    through copies of the weight that together exceed COLD_BYTES, as a
    decode step finds its weights."""
    from dynamo_tpu_torch.ops.cuda import int8_matmul as mk
    from dynamo_tpu_torch.ops.quant import int8_matmul_ref
    from dynamo_tpu_torch.tools.cases import matmul_case

    copies = max(2, -(-COLD_BYTES // (K * N)) + 1) if cold else 1
    cs = [matmul_case(M, K, N, device=DEV, seed=i) for i in range(copies)]
    x, q8, s = cs[0]["x"], cs[0]["q8"], cs[0]["s"]
    dq = (q8.float() * s).to(torch.bfloat16)  # dequantised outside the timed call
    t = dict(ms=time_ms(torch, lambda: mk.int8_matmul(x, q8, s), 50),
             plain_ms=time_ms(torch, lambda: int8_matmul_ref(x, q8, s), 10),
             library_ms=time_ms(torch, lambda: torch.matmul(x, dq), 50))
    del dq
    if cold:
        turn = [0]

        def rotate(fns):
            def call():
                turn[0] = (turn[0] + 1) % len(fns)
                return fns[turn[0]]()
            return call

        t["cold_ms"] = time_ms(torch, rotate([lambda c=c: mk.int8_matmul(c["x"], c["q8"], c["s"])
                                              for c in cs]), 50)
        dqs = [(c["q8"].float() * c["s"]).to(torch.bfloat16) for c in cs]
        t["library_cold_ms"] = time_ms(torch, rotate([lambda c=c, d=d: torch.matmul(c["x"], d)
                                                      for c, d in zip(cs, dqs)]), 50)
        del dqs
    del cs
    t["bound_ms"], t["bound_by"] = matmul_bound(M, K, N)
    return t


def matmul_layer_timing(torch, shapes, Ms, layer_label) -> dict:
    """The int8 product, its plain version and torch.matmul over the
    bf16-dequantised weight at each shape and row count (at M 32 warm and
    cold); returns one layer's products at M 32 (each shape times its count
    a layer), summed, warm — and prints that sum cold too."""
    smi = smi_line()
    layer = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    cold = dict(ms=0.0, library_ms=0.0, bound_ms=0.0)
    for label, (K, N, per_layer) in shapes.items():
        for M in Ms:
            t = matmul_times(torch, K, N, M, cold=M == 32)
            emit({"phase": "timing", "kernel": "int8_matmul", "case": f"{label} M{M}", **t,
                  "weight_bytes": K * N, "library": "torch.matmul over the bf16-dequantised weight",
                  "card": smi})
            if M == 32:
                for key in layer:
                    layer[key] += per_layer * t[key]
                cold["ms"] += per_layer * t["cold_ms"]
                cold["library_ms"] += per_layer * t["library_cold_ms"]
                cold["bound_ms"] += per_layer * t["bound_ms"]
    bound_by = "bytes" if all(matmul_bound(32, K, N)[1] == "bytes"
                              for K, N, _ in shapes.values()) else "operations"
    timed = dict(layer, bound_by=bound_by)
    emit({"phase": "timing", "kernel": "int8_matmul", "case": layer_label, "l2": "warm", **timed,
          "card": smi})
    emit({"phase": "timing", "kernel": "int8_matmul", "case": layer_label, "l2": "cold",
          **cold, "bound_by": bound_by, "card": smi})
    return timed


# -- head_dim 256: bf16-pool attention at Gemma shapes ---------------------


def d256_kernel_phases(torch):
    """Parity of both bf16-pool attention kernels at head_dim 256 on every
    tools.cases.D256_ATTENTION_CASES case (Gemma-2: KH 4, G 2, softcap 50,
    window 4,096 at contexts of 4,000-6,600; Gemma-3: KH 1, G 4, window 512;
    window boundaries inside pages and tiles), then the timing of each
    geometry's decode (B 16, C 1) and chunk (B 4, C 512) case. Returns the
    worst errors; the D 256 times are printed (and kept in PERF.md), while
    the kernels line keeps the D 64 cases of earlier runs."""
    from dynamo_tpu_torch.tools.cases import D256_ATTENTION_CASES, make_d256_attention_case

    cases = {label: make_d256_attention_case(label, DEV) for label in D256_ATTENTION_CASES}
    worst = attention_parity(torch, [(name, kind, label, case, win, cap)
                                     for label, (name, kind, case, win, cap) in cases.items()])
    reset_counts()  # parity launches do not count
    for geometry, dec, chunk in (
            ("gemma2 D256", "gemma2 D256 B16 C1 window 4096 softcap 50",
             "gemma2 D256 B4 C512 window 4096 softcap 50"),
            ("gemma3 D256", "gemma3 D256 B16 C1 window 512", "gemma3 D256 B4 C512 window 512")):
        _, _, dec_case, window, cap = cases[dec]
        attention_timing(torch, dec_case, cases[chunk][2], window=window, cap=cap, label=geometry)
    reset_counts()
    del cases
    gc.collect()
    torch.cuda.empty_cache()
    return worst


# -- Gemma-3-1B int8: int8-pool attention at head_dim 256, the tied int8 ---
# -- head at V 262,144 and the int8 product at d 1,152 ---------------------


def gemma3_int8_kernel_phases(torch):
    """Parity of both int8-pool attention kernels at head_dim 256 on every
    tools.cases.INT8_D256_ATTENTION_CASES case (Gemma-3: KH 1, G 4, window
    512 with its boundary inside a page and a tile, and global layers at
    contexts of 4,000-6,000), of the tied int8 head at Gemma-3's geometry
    (M 32 x K 1,152 x V 262,144) and of the int8 product at a Gemma-3
    layer's seven widths (M 32); then the timing of each: decode (B 32, C 1)
    and chunk (B 4, C 512) at window 512 and global, the head, and one
    layer's seven products. Returns the worst errors; the times are printed
    (and kept in PERF.md), while the kernels line keeps the cases of earlier
    runs."""
    from dynamo_tpu_torch.tools.cases import (
        GEMMA3_MATMUL_SHAPES, INT8_D256_ATTENTION_CASES, make_int8_attention_case,
    )

    cases = {label: make_int8_attention_case(label, DEV) for label in INT8_D256_ATTENTION_CASES}
    # The int8 limit of earlier runs: kernel and plain version read the same
    # codes and scales and fold the scales in at the same points.
    worst = attention_parity(torch, [(name, kind, label, case, win, cap)
                                     for label, (name, kind, case, win, cap) in cases.items()])
    head = head_case(torch, True, 32, 1152, 262144)
    worst["lm_head_int8"] = head_parity(torch, "gemma-3-1b tied M32", *head)
    worst["int8_matmul"] = matmul_parity(torch, GEMMA3_MATMUL_SHAPES, (32,))
    reset_counts()  # parity launches do not count
    for geometry in ("window 512", "global"):
        _, _, dec, window, _ = cases[f"gemma3 int8 D256 B32 C1 {geometry}"]
        attention_timing(torch, dec, cases[f"gemma3 int8 D256 B4 C512 {geometry}"][2], "_int8",
                         window=window, label=f"gemma3 int8 D256 {geometry}")
    head_timing(torch, "gemma-3-1b tied M32", *head)
    matmul_layer_timing(torch, GEMMA3_MATMUL_SHAPES, (32,),
                        "one Gemma-3-1B layer's seven products, M 32")
    reset_counts()
    del cases, head
    gc.collect()
    torch.cuda.empty_cache()
    return worst


def gemma3_fused_layer_phase(torch, smi) -> float:
    """The fused layer at a full Gemma-3-1B layer (tools/cases.py
    MODEL_LAYER_CASES: 32 rows at the engine phase's contexts, one at
    4,600; a local layer with its 512-key window and a global one) against
    its plain version (within MODEL_STEP_LIMIT bf16 steps, and at most
    MODEL_PAST_ONE_SHARE of x_out past one step), two runs bit-equal,
    finite; then its time beside the plain version's and its bound, and
    its µs a phase at the local layer. Returns the largest error."""
    from dynamo_tpu_torch.ops.cuda import fused_layer as fk
    from dynamo_tpu_torch.ops.fused_layer import fused_decoder_layer_ref
    from dynamo_tpu_torch.tools.cases import (
        MODEL_LAYER_CASES, MODEL_PAST_ONE_SHARE, MODEL_STEP_LIMIT, bf16_steps, make_layer_case,
        run_layer,
    )

    worst = 0.0
    for label in MODEL_LAYER_CASES:
        c, call = make_layer_case(label, DEV)
        got = run_layer(fk.fused_decoder_layer, c, call)
        again = run_layer(fk.fused_decoder_layer, c, call)
        ref = run_layer(fused_decoder_layer_ref, c, call)
        torch.cuda.synchronize()
        names = ("x_out", "k_new", "v_new")
        st = {n: bf16_steps(a, r) for n, a, r in zip(names, got, ref)}
        unit = 2.0**-7 * (ref[0].float().abs() + ref[0].float().pow(2).mean().sqrt())
        past_one = int(((got[0].float() - ref[0].float()).abs() > unit).sum())
        err = max(float((a.float() - r.float()).abs().max()) for a, r in zip(got, ref))
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        finite = all(bool(torch.isfinite(a.float()).all()) for a in got)
        ok = (same and finite and max(st.values()) <= MODEL_STEP_LIMIT
              and past_one <= MODEL_PAST_ONE_SHARE * got[0].numel())
        emit({"phase": "parity", "kernel": "fused_decoder_layer", "case": label,
              "max_abs_err": err, "bf16_steps": st, "x_out_past_one_step": past_one,
              "outputs": got[0].numel(), "repeatable": same,
              "tol": f"{MODEL_STEP_LIMIT} bf16 steps, {MODEL_PAST_ONE_SHARE} of x_out past one",
              "ok": ok})
        if not ok:
            fail(f"fused_decoder_layer ({label}) disagrees with its plain version: {st}, "
                 f"{past_one} values past one step, repeatable={same}, finite={finite}")
        worst = max(worst, err)
        reset_counts()  # parity launches do not count
        ms = time_ms(torch, lambda: run_layer(fk.fused_decoder_layer, c, call), 50)
        plain_ms = time_ms(torch, lambda: run_layer(fused_decoder_layer_ref, c, call), 5)
        bound_ms, bound_by = layer_bound(c, call)
        emit({"phase": "timing", "kernel": "fused_decoder_layer", "case": label, "ms": ms,
              "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
              "library_ms": None, "library": "none: no one PyTorch call computes a layer",
              "card": smi})
        del c, got, again, ref
    fused_layer_phases_line(torch, smi, "gemma3-1b B32 local", cluster_probe=False)
    return worst


# -- block size 128, and the last three TPU kernels (#5, #6, #7) ------------

# The first-step logits of prof_8b's v2 and bf modes against the full mode's:
# at most LOGIT_LIMIT apart (max |a - b|). The modes differ only in
# attention's probabilities (bf16 against float32), about a bf16 step of
# an attention output; carried through 32 layers to logits of std ~1, that
# moves a logit by a few hundredths. A wrong attention output (the floor
# mode's differs by whole units) moves them by far more.
LOGIT_LIMIT = 0.25


def bs128_phase(torch) -> dict:
    """Parity of both paged-attention kernels at block size 128 over bf16 and
    int8 pools on every tools.cases.BS128_ATTENTION_CASES case (D 128 at KH
    8, G 4, and one D 64 case; window boundaries in a page's second 64-key
    tile, chunks across a page edge), then the timing of the bf16 decode
    kernel at _prof_attn.py's case (B 64, context 160) and of the chunk
    kernel at B 4 x C 512. Returns the worst errors."""
    from dynamo_tpu_torch.tools.cases import (
        BS128_ATTENTION_CASES, make_bs128_attention_case, make_proto_attention_case,
    )

    cases = []
    for label in BS128_ATTENTION_CASES:
        for int8 in (False, True):
            name, kind, case, win, cap = make_bs128_attention_case(label, DEV, int8)
            cases.append((name, kind, f"{'int8' if int8 else 'bf16'} {label}", case, win, cap))
    worst = attention_parity(torch, cases)
    reset_counts()  # parity launches do not count
    dec, _, _ = make_proto_attention_case("llama3-8b B64 ctx 160 bs128", DEV)
    chunk = next(c[3] for c in cases if c[2] == "bf16 bs128 D128 B4 C512 ragged lens")
    attention_timing(torch, dec, chunk, label="llama-3-8b D128 bs128")
    reset_counts()
    del cases
    return worst


def ffn_bound(M, d, F):
    """Least time for the int8 FFN: the 3·d·F codes, the scales, x and out
    moved once (h stays on chip in the ideal); 6·M·d·F flops at the bf16
    peak."""
    t_bytes = (3 * d * F + 4 * (2 * F + d) + 2 * 2 * M * d) / HBM_BYTES_PER_S * 1e3
    t_ops = 6 * M * d * F / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# Every proto-kernel timing of the run, for the proto_cases line.
PROTO_TIMES = []
PROTO_MAIN = "llama3-8b B64 ctx 160 bs128"  # _prof_attn.py's case: the kernels line's times


def proto_kernel_phases(torch):
    """Parity of decode_packed (#6) and decode_bf16 (#7) against their plain
    version (decode_attention_bf16_ref) on every
    tools.cases.PROTO_ATTENTION_CASES case, at the wrapper's key splits and
    at forced splits 1, 2 and 16, and two runs bit for bit equal; of
    ffn_int8 (#5) against ffn_int8_ref at Llama-3-8B's FFN (d 4,096, F
    14,336) for 64 and 13 rows. Then the timing of #6 and #7 at every proto
    case beside the plain version, SDPA and the bound (a proto_cases line
    gathers them), both at forced splits at the main case (a proto_splits
    line), and #5 at 64 rows. Returns (worst errors, timings of the main
    cases)."""
    import torch.nn.functional as F

    from dynamo_tpu_torch.ops.attention import decode_attention_bf16_ref
    from dynamo_tpu_torch.ops.cuda import decode_attention_proto as dk
    from dynamo_tpu_torch.ops.cuda import ffn_int8 as fk
    from dynamo_tpu_torch.ops.ffn_int8 import ffn_int8_ref
    from dynamo_tpu_torch.tools.cases import (
        PROTO_ATTENTION_CASES, bf16_steps, ffn_case, make_proto_attention_case,
    )

    def args(case):
        return case["q"], case["k"], case["v"], case["tables"], case["start"]

    names = ("decode_packed", "decode_bf16")
    worst = {"decode_packed": 0.0, "decode_bf16": 0.0, "ffn_int8": 0.0}
    cases = {label: make_proto_attention_case(label, DEV) for label in PROTO_ATTENTION_CASES}
    for label, (case, win, cap) in cases.items():
        ref = decode_attention_bf16_ref(*args(case), win, logit_cap=cap)
        for name in names:
            fn = getattr(dk, name)
            auto = dk.split_count(case["q"], case["k"], name == "decode_packed")
            for splits in (None, 1, 2, 16):
                out = fn(*args(case), win, logit_cap=cap, splits=splits)
                torch.cuda.synchronize()
                err, ok = compare(torch, out, ref, case["clens"].tolist())
                tag = f"splits {auto} (the wrapper's)" if splits is None else f"splits {splits}"
                emit({"phase": "parity", "kernel": name, "case": f"{label}, {tag}",
                      "max_abs_err": err, "tol": f"{ATOL} + {RTOL}*|plain|", "ok": ok})
                if not ok:
                    fail(f"{name} ({label}, {tag}) disagrees with its plain version: "
                         f"max abs err {err}")
                worst[name] = max(worst[name], err)
            # the key groups and the splits are added in a fixed order
            same = torch.equal(fn(*args(case), win, logit_cap=cap),
                               fn(*args(case), win, logit_cap=cap))
            emit({"phase": "parity", "kernel": name, "case": f"{label}, two runs",
                  "splits": auto, "bit_equal": same, "ok": same})
            if not same:
                fail(f"{name} ({label}): two runs differ")
    d, ff = 4096, 14336
    ffn_inputs = {}
    for M in (64, 13):
        x, *w = ffn_inputs[M] = ffn_case(M, d, ff, device=DEV)
        out = fk.ffn_int8(x, *w)
        again = fk.ffn_int8(x, *w)
        ref = ffn_int8_ref(x, *w)
        torch.cuda.synchronize()
        steps = bf16_steps(out, ref)
        same = torch.equal(out, again)
        ok = steps <= STEP_LIMIT and same and bool(torch.isfinite(out.float()).all())
        err = float((out.float() - ref.float()).abs().max())
        emit({"phase": "parity", "kernel": "ffn_int8", "case": f"M{M} d{d} F{ff}",
              "max_abs_err": err, "max_abs_plain": float(ref.float().abs().max()),
              "bf16_steps": steps, "repeatable": same, "tol": f"{STEP_LIMIT} bf16 step",
              "ok": ok})
        if not ok:
            fail(f"ffn_int8 (M{M}) disagrees with its plain version: {steps} bf16 steps, "
                 f"repeatable={same}")
        worst["ffn_int8"] = max(worst["ffn_int8"], err)
    reset_counts()  # parity launches do not count

    timed = {}
    smi = smi_line()
    for label, (case, win, cap) in cases.items():
        library_ms = time_ms(torch, library_call(torch, case, win), 50)
        plain_ms = time_ms(torch, lambda: decode_attention_bf16_ref(*args(case), win,
                                                                   logit_cap=cap), 10)
        bound_ms, bound_by = bound(case, win)
        for name in names:
            fn = getattr(dk, name)
            row = dict(ms=time_ms(torch, lambda: fn(*args(case), win, logit_cap=cap), 50),
                       plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                       bound_by=bound_by)
            if label == PROTO_MAIN:
                timed[name] = row
            splits = dk.split_count(case["q"], case["k"], name == "decode_packed")
            PROTO_TIMES.append(dict(kernel=name, case=label, splits=splits, **row,
                                    sdpa_ratio=row["ms"] / library_ms))
            emit({"phase": "timing", "kernel": name, "case": label, "window": win,
                  "softcap": cap, "splits": splits, **row,
                  "library": "SDPA over the gathered pages" + (" without the softcap" if cap
                                                               else ""), "card": smi})
    # the split count's choice against its neighbours at the main case
    case, _, _ = cases[PROTO_MAIN]
    sweep = {name: {s: time_ms(torch, lambda: getattr(dk, name)(*args(case), splits=s), 50)
                    for s in (1, 2, 4, 8)} for name in names}
    emit({"phase": "proto_splits", "case": PROTO_MAIN, "ms": sweep,
          "wrapper": {n: dk.split_count(case["q"], case["k"], n == "decode_packed")
                      for n in names}, "card": smi})
    emit({"phase": "proto_cases", "cases": PROTO_TIMES, "card": smi})
    x, wg, wu, wd, sg, su, sd = ffn_inputs[64]
    # dequantised outside the timed call: bf16 weights with the scales folded in
    dq = [(w_.float() * s_).to(torch.bfloat16) for w_, s_ in ((wg, sg), (wu, su), (wd, sd))]

    def library():
        return torch.matmul(F.silu(torch.matmul(x, dq[0])) * torch.matmul(x, dq[1]), dq[2])

    timed["ffn_int8"] = dict(ms=time_ms(torch, lambda: fk.ffn_int8(x, wg, wu, wd, sg, su, sd), 50),
                             plain_ms=time_ms(torch, lambda: ffn_int8_ref(x, wg, wu, wd, sg, su,
                                                                           sd), 5),
                             library_ms=time_ms(torch, library, 50))
    timed["ffn_int8"]["bound_ms"], timed["ffn_int8"]["bound_by"] = ffn_bound(64, d, ff)
    emit({"phase": "timing", "kernel": "ffn_int8", "case": f"M64 d{d} F{ff}", **timed["ffn_int8"],
          "weight_bytes": 3 * d * ff,
          "library": "torch.matmul over the bf16-dequantised weights, plus silu", "card": smi})
    reset_counts()
    del cases, ffn_inputs, dq
    gc.collect()
    torch.cuda.empty_cache()
    return worst, timed


def prof_paths(torch, smi):
    """The entry points tools/prof_attn.py (B 64) and tools/prof_fused_ffn.py
    as a user runs them, each with the launch counts zeroed just before and
    read just after; their launches are exact (prof_attn: one parity call
    and 6 x 32 timed layer calls of #1 and of #6; prof_fused_ffn: one gate
    call and 6 x 16 chained calls of #5). Returns both paths' counts."""
    from dynamo_tpu_torch.tools import prof_attn, prof_fused_ffn

    reset_counts()
    res = prof_attn.run(64, DEV)
    counts_attn = read_counts()
    reset_counts()
    want = 1 + prof_attn.LAYERS * 6
    emit({"phase": "prof_attn", **res, "launches": counts_attn, "card": smi})
    for name in ("paged_attention_decode", "decode_packed"):
        if counts_attn[name] != want:
            fail(f"prof_attn: {name} launched {counts_attn[name]} times, expected {want}")
    res = prof_fused_ffn.run(DEV)
    counts_ffn = read_counts()
    reset_counts()
    emit({"phase": "prof_fused_ffn", **res, "launches": counts_ffn, "card": smi})
    want = 1 + prof_fused_ffn.CHAIN * 6
    if counts_ffn["ffn_int8"] != want:
        fail(f"prof_fused_ffn: ffn_int8 launched {counts_ffn['ffn_int8']} times, expected {want}")
    gc.collect()
    torch.cuda.empty_cache()
    return counts_attn, counts_ffn


def prof_8b_phase(torch, smi, params, cfg) -> dict:
    """tools/prof_8b.py's modes full, floor, v2 and bf on ``params`` (the
    int8 Llama-3-8B weights the engine phase built): B 64, block size 128,
    context 160, 16 steps a call. Each mode's decode-attention launches are
    exact; the first step's logits are finite, and v2's and bf's within
    LOGIT_LIMIT of full's. Then one call a mode under torch.profiler: device
    busy time a step and attention's part. Returns the launches of all
    modes, summed."""
    from dynamo_tpu_torch.tools import prof_8b

    steps = 16  # prof_8b's default, as _prof_8b.py's PSTEPS
    res = prof_8b.run(params, cfg, device=DEV)
    # Device time of one call a mode (the launches of these calls are not
    # counted): busy ms a step, and attention's part of it.
    setup = prof_8b.Setup(cfg, torch.device(DEV), 64, 128, 160)
    busy = {}
    with torch.inference_mode():
        for mode in res:
            with prof_8b.attention(mode):
                by_name, n_ops, _, _ = device_times(
                    lambda: setup.decode(params, cfg, steps).tokens.cpu())
            attn = sum(v for k, v in by_name.items() if "attention" in k)
            busy[mode] = dict(device_busy_ms_per_step=sum(by_name.values()) / steps,
                              attention_ms_per_step=attn / steps,
                              device_ops_per_step=n_ops / steps)
    del setup
    reset_counts()
    full = res["full"]["logits"]
    total = {n: 0 for n in prof_8b.ATTENTION_KERNELS}
    for mode, r in res.items():
        want = prof_8b.expected_launches(mode, cfg, steps, r["calls"])
        line = {"phase": "prof_8b", "mode": mode, "ms_step": r["ms_step"], "tok_s": r["tok_s"],
                **busy[mode], "launches": r["launches"], "expected": want,
                "logits_finite": bool(torch.isfinite(r["logits"]).all()),
                "max_abs_logit_diff_vs_full": float((r["logits"] - full).abs().max()),
                "logit_std": float(r["logits"].std()), "card": smi}
        emit(line)
        if r["launches"] != want:
            fail(f"prof_8b {mode}: launches {r['launches']}, expected {want}")
        if not line["logits_finite"]:
            fail(f"prof_8b {mode}: non-finite logits")
        if mode in ("v2", "bf") and line["max_abs_logit_diff_vs_full"] > LOGIT_LIMIT:
            fail(f"prof_8b {mode}: first-step logits {line['max_abs_logit_diff_vs_full']} from "
                 f"the full mode's (limit {LOGIT_LIMIT})")
        for n in total:
            total[n] += r["launches"][n]
    del res
    gc.collect()
    torch.cuda.empty_cache()
    return total


# -- engine ---------------------------------------------------------------


async def drive_engine(torch, engine, prompts, shared, max_tokens):
    from dynamo_tpu_torch.llm.protocols.common import (
        PreprocessedRequest, SamplingOptions, StopConditions,
    )
    from dynamo_tpu_torch.runtime.context import Context

    def req(p):
        return PreprocessedRequest(
            token_ids=p, sampling=SamplingOptions(temperature=0.0),
            stop=StopConditions(max_tokens=max_tokens),
        )

    async def one(p, first_event=None):
        t0 = time.monotonic()
        stamps, toks, reason = [], [], None
        async for out in engine.generate(req(p), Context()):
            if out.error:
                raise RuntimeError(out.error)
            if out.token_ids:
                stamps.append((time.monotonic(), len(out.token_ids)))
                toks += out.token_ids
                if first_event is not None:
                    first_event.set()
            reason = out.finish_reason
        return dict(t0=t0, stamps=stamps, tokens=toks, reason=reason, prompt=p)

    async def after(event, p):
        await event.wait()  # the sharer's blocks are committed once it streams
        return await one(p)

    t_start = time.monotonic()
    tasks = [one(p) for p in prompts]
    if shared:  # the second sharer starts once the first one streams
        ev = asyncio.Event()
        tasks = [one(shared[0], ev), after(ev, shared[1])] + tasks
    results = await asyncio.gather(*tasks)
    wall = time.monotonic() - t_start
    return results, wall


def kernel_modules():
    from dynamo_tpu_torch.ops.cuda import (
        decode_attention_proto, ffn_int8, fused_layer, int8_matmul, lm_head, paged_attention,
    )

    return (paged_attention, fused_layer, lm_head, int8_matmul, decode_attention_proto, ffn_int8)


def reset_counts() -> None:
    for m in kernel_modules():
        m.reset_launch_counts()


def read_counts() -> dict:
    from dynamo_tpu_torch.ops.cuda import paged_attention

    out = dict(paged_attention.int8_launch_counts)
    for m in kernel_modules():
        out.update(m.launch_counts)
    return out


def engine_phase(torch, smi, cfg, expect, gap_limit, phase, *, slots=16, n_short=5,
                 max_tokens=64, max_model_len=2048, extra_lengths=(), embed_scale=None,
                 median_rank_limit=None, mean_gap_share=None, **engine_kw):
    """Serve cfg through TorchEngine.generate() at the engine's defaults
    (pipeline depth 2, each decode width bucket one CUDA graph);
    ``expect``: the kernels this path must launch. The request set: two
    prompts sharing a 256-token prefix, ``n_short`` prompts of 100-300
    tokens, one of 1,200 and one of each of ``extra_lengths`` tokens, each
    for ``max_tokens`` greedy tokens. The last short prompt is then served
    alone twice: at the defaults, and at depth 1 with the bursts run
    eagerly (the reference the graphs are held against); the two streams
    must be equal. The first short request and every ``extra_lengths``
    request are checked against a teacher-forced dense forward.
    ``embed_scale`` multiplies the random embedding (tied heads: the head
    too). The limits: ``gap_limit`` on each token's gap below the
    reference's best logit (None: not checked), ``median_rank_limit`` on
    the median rank of a stream's tokens among the reference's logits, and
    ``mean_gap_share`` on its mean gap as a share of the gap a random token
    would have. Over int8 KV pools the reference reads K and V through the
    same int8 round trip. Returns (launch counts, engine, decode steps of
    the request set)."""
    from dynamo_tpu_torch.engines.gpu.engine import (
        TorchEngine, TorchEngineArgs, table_width_bucket,
    )

    args = TorchEngineArgs(
        config=cfg, block_size=16, num_kv_blocks=2048, max_num_seqs=slots,
        max_model_len=max_model_len, prefill_chunk=512, seed=0, device=DEV, **engine_kw,
    )
    t0 = time.monotonic()
    engine = TorchEngine(args, scaled_params(torch, cfg, args, embed_scale))
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    g = torch.Generator().manual_seed(11)
    rand = lambda n: torch.randint(10, cfg.vocab_size, (n,), generator=g).tolist()  # noqa: E731
    prefix = rand(256)
    shared = [prefix + rand(40), prefix + rand(70)]
    if n_short == 5:
        lengths = [100, 140, 180, 230, 300]
    else:
        lengths = torch.randint(100, 301, (n_short,), generator=g).tolist()
    prompts = [rand(n) for n in lengths] + [rand(1200)]
    extra = [rand(n) for n in extra_lengths]
    repeat = prompts[n_short - 1]  # the last short prompt

    async def run():
        try:
            # Warm-up (first cuBLAS/kernel loads), not measured or counted.
            await drive_engine(torch, engine, [rand(120), rand(700)], [], 16)
            # and one request alone a decode width bucket the request set
            # can reach, so every graph is captured before the measured run
            # (a capture costs about one eager burst; capture_ms says how
            # much in all)
            K, BS = args.decode_steps, args.block_size
            longest = max(lengths + [1200] + list(extra_lengths)) + max_tokens + 2 * K
            b = table_width_bucket(-(-(min(lengths) + K) // BS), args.max_blocks_per_seq)
            while b <= table_width_bucket(-(-longest // BS), args.max_blocks_per_seq):
                n = min(BS * b - K - BS // 2, args.max_model_len - 2 * K - 1)
                await drive_engine(torch, engine, [rand(n)], [], 2 * K)
                b *= 2
            torch.cuda.reset_peak_memory_stats()
            bursts0, steps0 = engine.runner.mk_fused_bursts, engine.steps
            reset_counts()
            results, wall = await drive_engine(torch, engine, prompts + extra, shared, max_tokens)
            counts = read_counts()
            peak = torch.cuda.max_memory_allocated()
            bursts = engine.runner.mk_fused_bursts - bursts0
            decode_steps = (engine.steps - steps0) * args.decode_steps
            # A greedy request repeated alone, twice (same cache hits, same
            # shapes): at the defaults, then at depth 1 with eager bursts.
            # The two must give the same tokens.
            again = []
            defaults = args.pipeline_depth, args.cuda_graphs
            for depth, graphs in (defaults, (1, False)):
                args.pipeline_depth, args.cuda_graphs = depth, graphs
                rs, _ = await drive_engine(torch, engine, [repeat], [], max_tokens)
                again.append(rs[0]["tokens"])
            args.pipeline_depth, args.cuda_graphs = defaults
            return results, wall, counts, peak, bursts, decode_steps, again
        finally:
            await engine.stop()

    results, wall, counts, peak, bursts, decode_steps, again = asyncio.run(run())
    stats = engine.stats()
    for r in results:
        if len(r["tokens"]) != max_tokens or r["reason"] is None or r["reason"].value != "length":
            fail(f"a stream ended with {len(r['tokens'])} tokens ({r['reason']}), expected {max_tokens}")
    if stats["nonfinite_logit_rows"]:
        fail(f"{stats['nonfinite_logit_rows']} decode rows had non-finite logits")
    if again[0] != again[1]:
        fail("a greedy request served alone at depth 2 with CUDA graphs and at depth 1 "
             "eagerly gave different tokens")
    if not stats["decode_graphs"] or not stats["graph_replays"]:
        fail(f"the decode bursts did not run as CUDA graphs: {stats}")
    for name in expect:
        if counts[name] <= 0:
            fail(f"{name} never launched on the {cfg.name} path")
    if engine.runner.use_megakernel:
        if bursts <= 0:
            fail("no decode burst went through the fused layer")
        want = bursts * args.decode_steps * cfg.n_layers
        if counts["fused_decoder_layer"] != want:
            fail(f"fused_decoder_layer launched {counts['fused_decoder_layer']} times, "
                 f"expected {want} (one a layer a decode step)")

    def dense_logits(prompt, tokens):
        return dense_reference_logits(torch, engine, prompt, tokens)

    # The repeated request against its run inside the batch: prefill there
    # ran at other shapes, so a near-tie may go the other way; where the
    # streams part, both tokens must be within the gap limit of the dense
    # reference's best.
    batched = next(x["tokens"] for x in results if x["prompt"] is repeat)
    part = next((i for i, (a, b) in enumerate(zip(batched, again[0])) if a != b), None)
    part_gap = 0.0
    if part is not None:
        at = dense_logits(repeat, batched[: part + 1])[-1]  # predicts token `part`
        part_gap = float(at.max() - min(at[batched[part]], at[again[0][part]]))
    for r in [results[2]] + [next(x for x in results if x["prompt"] is p) for p in extra]:
        ref = dense_logits(r["prompt"], r["tokens"])
        picked = torch.tensor(r["tokens"], device=DEV)
        gap = ref.max(dim=-1).values - ref[torch.arange(len(r["tokens"]), device=DEV), picked]
        top2 = ref.topk(2, dim=-1).values
        # each engine token's rank among the reference's logits (0: its
        # argmax), and the gap a token drawn at random would have
        rank = (ref > ref[torch.arange(len(r["tokens"]), device=DEV), picked][:, None]).sum(-1)
        random_gap = float((ref.max(dim=-1).values - ref.mean(dim=-1)).mean())
        inputs = (r["prompt"] + r["tokens"])[len(r["prompt"]) - 1 : -1]
        emit({"phase": f"{phase}_reference", "prompt_tokens": len(r["prompt"]),
              "tokens": len(r["tokens"]), "exact_argmax": int((gap == 0).sum()),
              "repeats_input_share": sum(a == b for a, b in zip(r["tokens"], inputs))
              / len(r["tokens"]),
              "max_logit_gap": float(gap.max()), "gap_limit": gap_limit,
              "mean_logit_gap": float(gap.mean()), "random_token_gap": random_gap,
              "mean_gap_share_limit": mean_gap_share,
              "median_rank": int(rank.median()), "median_rank_limit": median_rank_limit,
              "max_rank": int(rank.max()),
              "logit_std": float(ref.std()),
              "min_top2_margin": float((top2[:, 0] - top2[:, 1]).min()),
              "repeat_parts_from_batched_run_at": part,
              "repeat_part_gap": part_gap})
        where = f"{len(r['prompt'])}-token prompt"
        if gap_limit is not None and float(gap.max()) > gap_limit:
            fail(f"engine token is {float(gap.max())} below the dense reference's max logit "
                 f"({where})")
        if median_rank_limit is not None and int(rank.median()) > median_rank_limit:
            fail(f"the engine's tokens rank {int(rank.median())} (median) among the dense "
                 f"reference's logits, above {median_rank_limit} ({where})")
        if mean_gap_share is not None and float(gap.mean()) > mean_gap_share * random_gap:
            fail(f"the engine's tokens lie {float(gap.mean())} below the dense reference's "
                 f"best on average, above {mean_gap_share} x a random token's {random_gap} "
                 f"({where})")
        del ref, top2, rank
    if gap_limit is not None and part_gap > gap_limit:
        fail(f"the repeated request parted from its batched run at token {part} by a "
             f"logit gap of {part_gap}")

    ttft = [r["stamps"][0][0] - r["t0"] for r in results]
    itl = []
    for r in results:
        (t_first, _), (t_last, _) = r["stamps"][0], r["stamps"][-1]
        itl.append((t_last - t_first) / max(len(r["tokens"]) - 1, 1))
    gen = sum(len(r["tokens"]) for r in results)
    emit({
        "phase": phase, "model": cfg.name, "layers": cfg.n_layers, "requests": len(results),
        "max_tokens": max_tokens, "init_s": init_s, "wall_s": wall,
        "ttft_ms_mean": 1e3 * sum(ttft) / len(ttft), "ttft_ms_max": 1e3 * max(ttft),
        "itl_ms_mean": 1e3 * sum(itl) / len(itl), "output_tok_per_s": gen / wall,
        "peak_mem_gib": peak / 2**30,
        "fused_bursts": bursts, "decode_steps": decode_steps, "launches": counts,
        "stats": stats, "card": smi,
    })
    return counts, engine, decode_steps


def dense_reference_logits(torch, engine, prompt, tokens):
    """Teacher-forced dense check's reference: the logits [len(tokens), V]
    (float32) of a dense forward of the engine's model over prompt +
    emitted tokens, each row predicting the token at its place (no paged
    attention and no fused layer on that path; over int8 KV pools K and V
    pass through the int8 round trip)."""
    from dynamo_tpu_torch.models import llama

    cfg, seq = engine.config, prompt + tokens
    with torch.inference_mode(), int8_round_trip(llama, engine.args.kv_cache_dtype == "int8"):
        kc, vc = llama.init_kv_cache(cfg, (len(seq) + 15) // 16, 16, DEV)
        logits, _, _ = llama.forward_paged(
            engine.runner.params, cfg, torch.tensor([seq], device=DEV),
            torch.zeros(1, dtype=torch.int32, device=DEV),
            torch.tensor([len(seq)], dtype=torch.int32, device=DEV),
            torch.arange(len(kc[0]), dtype=torch.int32, device=DEV)[None],
            kc, vc, all_logits=True, first_chunk=True,
        )
    return logits[0, len(prompt) - 1 : len(seq) - 1].float()


def check_int8kv_path(engine, counts, decode_steps) -> None:
    """The launches of an int8-weight, int8-KV path (the fused layer off by
    its gate): int8-pool decode attention at least once a layer a decode
    step, seven int8 products a layer a step, and no bf16-pool attention or
    fused layer."""
    n_layers = engine.config.n_layers
    if engine.runner.use_megakernel or engine.stats()["mk_fused_bursts"]:
        fail("the fused layer ran under int8 KV pools")
    others = {n: counts[n] for n in ("paged_attention_decode", "paged_attention_chunk",
                                     "fused_decoder_layer") if counts[n]}
    if others:
        fail(f"bf16-pool or fused kernels launched on an int8-KV path: {others}")
    if counts["paged_attention_decode_int8"] < n_layers * decode_steps:
        fail(f"paged_attention_decode_int8 launched {counts['paged_attention_decode_int8']} "
             f"times, fewer than {n_layers} layers x {decode_steps} decode steps")
    if counts["int8_matmul"] < 7 * n_layers * decode_steps:
        fail(f"int8_matmul launched {counts['int8_matmul']} times, fewer than 7 x "
             f"{n_layers} layers x {decode_steps} decode steps")


def fused_burst_launches(engine) -> dict:
    """The exact launches of one decode burst through the fused layer: one a
    layer a step, one head a step, no other kernel."""
    layers, steps = engine.config.n_layers, engine.args.decode_steps
    return {"fused_decoder_layer": layers * steps, "lm_head_int8": steps, "int8_matmul": 0,
            "paged_attention_decode": 0, "paged_attention_chunk": 0,
            "paged_attention_decode_int8": 0, "paged_attention_chunk_int8": 0}


def int8kv_burst_launches(engine) -> dict:
    """The exact launches of one decode burst on an int8-KV path: a decode
    attention and seven products a layer a step, one head a step, no other
    kernel."""
    layers, steps = engine.config.n_layers, engine.args.decode_steps
    return {"paged_attention_decode_int8": layers * steps, "int8_matmul": 7 * layers * steps,
            "lm_head_int8": steps, "paged_attention_chunk_int8": 0, "paged_attention_decode": 0,
            "paged_attention_chunk": 0, "fused_decoder_layer": 0}


@contextlib.contextmanager
def int8_round_trip(llama, on):
    """While on: models/llama's dense attention reads K and V as int8 pools
    hold them (each token's codes times its scale, float32), so a dense
    reference of an int8-KV engine carries the same rounding of K and V."""
    attend = llama.dense_chunk_attention
    if on:
        from dynamo_tpu_torch.ops.kv_quant import quantize_kv_chunk

        def held(x):
            q8, s = quantize_kv_chunk(x)
            return q8.float() * s[..., None]

        llama.dense_chunk_attention = lambda q, k, v, lens, **kw: attend(
            q, held(k), held(v), lens, **kw)
    try:
        yield
    finally:
        llama.dense_chunk_attention = attend


def scaled_params(torch, cfg, args, scale):
    """The engine's random weights (its seed, its quantization) with the
    embedding multiplied by ``scale``; None (the engine makes its own) when
    no scale is given. An int8 embedding keeps its codes and scales its
    per-row scales."""
    if scale is None:
        return None
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.models.quantize import init_quantized_params

    with torch.no_grad():
        if args.quantization:
            params = init_quantized_params(cfg, args.seed, DEV)
            params["embed"]["s"].mul_(scale)
        else:
            params = llama.init_params(cfg, args.seed, DEV)
            params["embed"] = (params["embed"].float() * scale).to(cfg.dtype)
    return params


# Host-side calls that put work on the card, as torch.profiler names the
# CUDA API calls.
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchCooperativeKernel",
                "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                "cudaMemsetAsync")


def device_times(fn):
    """(device ms by op name, device ops, kernels among them, host launch
    calls) of one call of ``fn`` under torch.profiler: the sum of each
    device op's durations (one stream, so they do not overlap; ops are
    kernels and memory copies) and the runtime calls that enqueued work
    (LAUNCH_CALLS)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
    by_name, n_ops, n_kernels, n_calls = {}, 0, 0, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
            n_ops += 1
            n_kernels += not ("Memcpy" in e.name or "Memset" in e.name)
        elif e.name.split("_v")[0] in LAUNCH_CALLS:
            n_calls += 1
    return by_name, n_ops, n_kernels, n_calls


def event_ms(torch, fn, iters=3):
    """Device time of ``fn`` by CUDA events around it, mean of ``iters``."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def burst_both_ways(torch, runner, burst):
    """The profile burst from the same pools and slot state, once eagerly
    and once by graph replay: tokens, finite flags and every pool byte must
    be bit-equal (the kernels are deterministic). Leaves the pools as the
    burst wrote them."""
    pools = [t for p in runner.k_cache + runner.v_cache
             for t in (p.values() if isinstance(p, dict) else (p,))]
    before = [t.clone() for t in pools]
    outs = []
    defaults = runner.args.cuda_graphs
    for graphs in (False, True):
        runner.args.cuda_graphs = graphs
        for t, b in zip(pools, before):
            t.copy_(b)
        nb = runner.sync_all(*burst)
        toks, finite = runner.decode_read(runner.decode_dispatch(nb))[:2]
        if graphs:  # the first use of this width ran eagerly and captured: replay it
            for t, b in zip(pools, before):
                t.copy_(b)
            runner.sync_all(*burst)
            toks, finite = runner.decode_read(runner.decode_dispatch(nb))[:2]
        torch.cuda.synchronize()
        outs.append((toks, finite, [t.clone() for t in pools]))
    runner.args.cuda_graphs = defaults
    (t0, f0, p0), (t1, f1, p1) = outs
    same_pools = all(torch.equal(a, b) for a, b in zip(p0, p1))
    written = sum(int((a != b).sum()) for a, b in zip(p0, before))
    del before, outs, p0, p1
    return bool((t0 == t1).all()) and bool((f0 == f1).all()) and same_pools, written


def profile_phase(torch, runner, smi, phase="profile", ctx_step=80, exact=None):
    """One 8-step decode burst of every slot (contexts 100, 100 + ctx_step,
    ...) through the engine's runner, eagerly and as a CUDA graph: the two
    must be bit-equal (tokens, finite flags, pools). For each mode: host
    wall (median of 5), device busy time (sum of kernel durations under
    torch.profiler; one stream, so kernels do not overlap), the idle share,
    kernels and host launch calls a step, the kernels that take the most
    device time, and the shares of the fused layer, the int8 product and
    int8-pool attention; one line a mode. ``exact``: launch counts each
    mode's burst must show (under replay: the graph's capture deltas). A
    ``{phase}_graphs`` line sets the modes side by side, with the graphs
    the runner captured, their capture time and replays."""
    import numpy as np

    S, BS = runner.args.max_num_seqs, runner.args.block_size
    K = runner.args.decode_steps
    pos = np.array([100 + ctx_step * i for i in range(S)], np.int32)
    width = int(pos.max() + 2 * K) // BS + 1
    burst = (
        np.ones(S, np.int32), pos, np.ones(S, np.int32),
        np.arange(S * width, dtype=np.int32).reshape(S, width),
        np.zeros(S, np.float32), np.zeros(S, np.int32), np.ones(S, np.float32),
        np.arange(S, dtype=np.int32),
    )
    same, written = burst_both_ways(torch, runner, burst)
    if not same:
        fail(f"{phase}: the graph-replayed burst differs from the eager one")
    modes = {}
    defaults = runner.args.cuda_graphs
    for mode, graphs in (("eager", False), ("graphs", True)):
        runner.args.cuda_graphs = graphs
        runner.run_decode(*burst)  # run_decode reads its tokens back: synchronised
        walls = []
        for _ in range(5):  # host time varies run to run: keep the median
            t0 = time.monotonic()
            runner.run_decode(*burst)
            walls.append(1e3 * (time.monotonic() - t0))
        wall_ms = sorted(walls)[len(walls) // 2]
        reset_counts()
        by_name, n_ops, n_kernels, n_calls = device_times(lambda: runner.run_decode(*burst))
        counts = read_counts()
        reset_counts()
        for name, want in (exact or {}).items():
            if counts[name] != want:
                fail(f"{phase} ({mode}): {name} launched {counts[name]} times in one burst, "
                     f"expected {want}")
        busy_ms = sum(by_name.values())
        if busy_ms <= 0:
            fail(f"{phase} ({mode}): the profiler saw no device time in a decode burst")
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        attn = sum(v for k, v in by_name.items() if "paged_attention" in k)
        fused = sum(v for k, v in by_name.items() if "fused_layer" in k)
        # the int8 product runs int8_stream.cuh's stream_kernel
        matmul = sum(v for k, v in by_name.items() if "stream_kernel" in k)
        attn8 = sum(v for k, v in by_name.items() if "paged_attention" in k and "Int8Pool" in k)
        line = {"phase": phase, "mode": mode, "what": "one decode burst",
                "model": runner.config.name, "steps": K, "rows": S,
                "contexts": [int(pos[0]), int(pos[-1])],
                "wall_ms": wall_ms, "wall_ms_min": min(walls), "device_busy_ms": busy_ms,
                "device_busy_ms_per_step": busy_ms / K,
                "device_idle_share": max(0.0, 1 - busy_ms / wall_ms),
                "attention_ms": attn, "attention_share": attn / busy_ms,
                "fused_layer_ms": fused, "fused_layer_share": fused / busy_ms,
                "int8_matmul_ms": matmul, "int8_matmul_share": matmul / busy_ms,
                "int8_attention_ms": attn8, "int8_attention_share": attn8 / busy_ms,
                "device_ops_per_step": n_ops / K, "kernels_per_step": n_kernels / K,
                "host_launch_calls_per_step": n_calls / K,
                "launches": counts, "top_ms": [[k[:60], v] for k, v in top], "card": smi}
        emit(line)
        modes[mode] = line
    runner.args.cuda_graphs = defaults
    eager, graph = modes["eager"], modes["graphs"]
    # Device ops (a copy inside a graph may be reported as a kernel where
    # eager reports a memcpy), within 1 %: the profiler's count of one
    # eager burst itself moves by a few ops a step between runs.
    seen = abs(graph["device_ops_per_step"] / eager["device_ops_per_step"] - 1) <= 0.01
    # Where the profiler does not see the kernels inside a replay, the
    # replay's device time comes from CUDA events around it instead.
    nb = runner.sync_all(*burst)
    replay = runner.graphs[(nb, False, False)]
    replay_event_ms = event_ms(torch, replay.graph.replay)
    torch.cuda.synchronize()
    busy = graph["device_busy_ms"] if seen else replay_event_ms
    emit({"phase": f"{phase}_graphs", "model": runner.config.name,
          "eager_equals_replay": same, "pool_values_written": written,
          "buckets_captured": sorted(runner.graphs), "capture_ms": runner.capture_ms,
          "replays": sum(g.replays for g in runner.graphs.values()),
          "kernel_launches_a_replay": replay.launches,
          "wall_ms": {"eager": eager["wall_ms"], "graphs": graph["wall_ms"]},
          "device_busy_ms_per_step": {"eager": eager["device_busy_ms_per_step"],
                                      "graphs": busy / K},
          "device_idle_share": {"eager": eager["device_idle_share"],
                                "graphs": max(0.0, 1 - busy / graph["wall_ms"])},
          "device_ops_per_step": {"eager": eager["device_ops_per_step"],
                                  "graphs": graph["device_ops_per_step"]},
          "kernels_per_step": {"eager": eager["kernels_per_step"],
                               "graphs": graph["kernels_per_step"]},
          "host_launches_per_step": {"eager": eager["host_launch_calls_per_step"],
                                     "graphs": graph["host_launch_calls_per_step"]},
          "profiler_sees_replay_kernels": seen, "replay_event_ms": replay_event_ms,
          "card": smi})


# -- logits processors and logprobs (ROADMAP A3) -----------------------------

PROCS_MAX_TOKENS = 64
PROCS_FORCED = 1000  # the token the forcing row's logit_bias sets to +100
PROCS_MIN_P = dict(temperature=0.8, min_p=0.1)


def procs_rows(plain):
    """The processors phase's mixed batch, (name, sampling) a row, given
    each row's stream when every row is plain: three plain rows; the
    repetition, presence and frequency penalties (the last < 0, so that it
    moves a stream that seldom repeats a token); a row whose logit_bias bans
    the first 8 tokens its plain stream takes; a row forcing one token with
    +100; min_p at temperature 0.8; and logprobs 0, 5 and 20 (the penalty
    and bias rows ask for 5)."""
    greedy = dict(temperature=0.0)
    return [
        ("plain", greedy), ("plain", greedy), ("plain", greedy),
        ("repetition", dict(greedy, repetition_penalty=1.3, logprobs=5)),
        ("presence", dict(greedy, presence_penalty=1.5, logprobs=5)),
        ("frequency", dict(greedy, frequency_penalty=-1.0, logprobs=5)),
        ("ban", dict(greedy, logit_bias={t: -100 for t in plain[6][:8]}, logprobs=5)),
        ("force", dict(greedy, logit_bias={PROCS_FORCED: 100}, logprobs=0)),
        ("min_p", dict(PROCS_MIN_P, logprobs=20)),
        ("logprobs0", dict(greedy, logprobs=0)),
        ("logprobs5", dict(greedy, logprobs=5)),
        ("logprobs20", dict(greedy, logprobs=20)),
    ]


async def serve_rows(engine, prompts, samplings, max_tokens):
    """Each prompt with its sampling options through generate(), all at
    once: a dict a row with its tokens, logprob entries ((id, logprob), the
    sampled token's first) and finish reason."""
    from dynamo_tpu_torch.llm.protocols.common import (
        PreprocessedRequest, SamplingOptions, StopConditions,
    )
    from dynamo_tpu_torch.runtime.context import Context

    async def one(prompt, sampling):
        req = PreprocessedRequest(token_ids=prompt, sampling=SamplingOptions(**sampling),
                                  stop=StopConditions(max_tokens=max_tokens))
        toks, logprobs, reason = [], [], None
        async for out in engine.generate(req, Context()):
            if out.error:
                raise RuntimeError(out.error)
            toks += out.token_ids
            logprobs += [[(e.token_id, e.logprob) for e in entry] for entry in out.logprobs or []]
            reason = out.finish_reason
        return dict(tokens=toks, logprobs=logprobs, reason=reason)

    return await asyncio.gather(*(one(p, s) for p, s in zip(prompts, samplings)))


def processed_reference(torch, engine, prompt, tokens, sampling):
    """The dense reference's logits for a row (dense_reference_logits) with
    the row's processors applied as the engine applies them, teacher-forced:
    the penalties at each token see the prompt and the tokens emitted
    before it (ops/logits_process, the plain torch the CPU tests hold
    against JAX). Returns the logits [T, V] (float32) before and after."""
    from dynamo_tpu_torch.ops import logits_process as lp

    ref = dense_reference_logits(torch, engine, prompt, tokens)
    T, V = ref.shape
    ids, vals = lp.pack_bias(sampling.get("logit_bias"), V)
    t = torch.tensor(tokens, device=DEV)
    onehot = torch.zeros(T, V, dtype=torch.int32, device=DEV)
    onehot[torch.arange(T, device=DEV), t] = 1
    counts = torch.cumsum(onehot, 0) - onehot  # tokens before each place
    mask = torch.zeros(T, V, dtype=torch.bool, device=DEV)
    mask[:, torch.tensor(prompt, device=DEV)] = True
    full = lambda v: torch.full((T,), float(v), device=DEV)  # noqa: E731
    params = lp.ProcParams(
        rep=full(sampling.get("repetition_penalty") or 1.0),
        pres=full(sampling.get("presence_penalty") or 0.0),
        freq=full(sampling.get("frequency_penalty") or 0.0),
        bias_ids=torch.from_numpy(ids).to(DEV).long()[None].expand(T, -1),
        bias_vals=torch.from_numpy(vals).to(DEV)[None].expand(T, -1))
    return ref, lp.apply(ref, params, lp.ProcState(counts, mask))


def procs_phase(torch, smi, args, params, phase, *, gap_limit=None, median_rank_limit=None,
                mean_gap_share=None, logprob_limit=None, top_overlap_limit=None):
    """Logits processors, min_p and logprobs served through generate() on a
    fresh engine with the given args and weights, at the defaults (depth 2,
    graphs). The same 12 prompts served four times: every row plain (to
    fill the prefix cache), every row plain again; the mixed batch of
    procs_rows; the mixed batch again at depth 1 with eager bursts.
    Holds: the mixed batch at depth 2 with graphs gives the same
    tokens as at depth 1 eagerly, and the same logprobs (the same kernels
    on the same inputs: within 1e-6); each plain row streams what it
    streams in the all-plain run (the processor variant leaves neutral rows
    as they were); no banned token appears and the forced row emits only
    its token (logprob ~0); each logprobs row carries 1 + min(n, 20)
    entries a token, the first token's included; every min_p token lies in
    the set the filter keeps (by its own logprobs); and each greedy row that
    sets a processor or asks for logprobs against the processed dense
    reference (processed_reference): each token's gap below the reference's
    best and its rank among the reference's logits (``gap_limit``,
    ``median_rank_limit``, ``mean_gap_share`` as engine_phase holds them,
    over all those rows' tokens), its logprob against the reference's
    (``logprob_limit``, the largest difference) and the share of the top-N
    ids the two share (``top_overlap_limit``, the smallest over tokens). A
    limit of None is read and printed, not held. Returns the engine."""
    from dynamo_tpu_torch.engines.gpu.engine import TorchEngine

    engine = TorchEngine(args, params)
    cfg = engine.config
    g = torch.Generator().manual_seed(23)
    prompts = [torch.randint(10, cfg.vocab_size, (n,), generator=g).tolist()
               for n in (110, 150, 190, 230, 270, 130, 170, 210, 250, 120, 160, 200)]
    greedy = [dict(temperature=0.0)] * len(prompts)

    async def run():
        try:
            # every run after the first hits the same cached prompt blocks,
            # so its prefill runs at the same shapes (the first's, over the
            # whole prompts, rounds otherwise: this model is chaotic)
            await serve_rows(engine, prompts, greedy, PROCS_MAX_TOKENS)
            plain = await serve_rows(engine, prompts, greedy, PROCS_MAX_TOKENS)
            rows = procs_rows([r["tokens"] for r in plain])
            samplings = [sp for _, sp in rows]
            reset_counts()
            salt = engine._next_salt
            t0 = time.monotonic()
            mixed = await serve_rows(engine, prompts, samplings, PROCS_MAX_TOKENS)
            wall = time.monotonic() - t0
            counts = read_counts()
            defaults = args.pipeline_depth, args.cuda_graphs
            args.pipeline_depth, args.cuda_graphs = 1, False
            # the same salts (arrival order) as the run above: the min_p row
            # draws the same noise
            engine._next_salt = salt
            eager = await serve_rows(engine, prompts, samplings, PROCS_MAX_TOKENS)
            args.pipeline_depth, args.cuda_graphs = defaults
            return plain, rows, mixed, eager, counts, wall
        finally:
            await engine.stop()

    plain, rows, mixed, eager, counts, wall = asyncio.run(run())
    names = [name for name, _ in rows]
    for (name, _), m, e in zip(rows, mixed, eager):
        if len(m["tokens"]) != PROCS_MAX_TOKENS or m["reason"].value != "length":
            fail(f"{phase}: the {name} row ended with {len(m['tokens'])} tokens ({m['reason']})")
        if m["tokens"] != e["tokens"]:
            fail(f"{phase}: the {name} row's tokens at depth 2 with CUDA graphs differ from "
                 "depth 1 eager")
    eager_diff = max((abs(a[0][1] - b[0][1]) for m, e in zip(mixed, eager)
                      for a, b in zip(m["logprobs"], e["logprobs"])), default=0.0)
    if eager_diff > 1e-6:
        fail(f"{phase}: logprobs at depth 2 with CUDA graphs differ from depth 1 eager by "
             f"{eager_diff}")
    for i, name in enumerate(names):
        if name == "plain" and mixed[i]["tokens"] != plain[i]["tokens"]:
            fail(f"{phase}: plain row {i} streams other tokens beside processor rows")
    ban = mixed[names.index("ban")]
    banned = set(rows[names.index("ban")][1]["logit_bias"])
    if banned & set(ban["tokens"]) or ban["tokens"] == plain[names.index("ban")]["tokens"]:
        fail(f"{phase}: the ban row emitted a banned token or its plain stream")
    force = mixed[names.index("force")]
    if set(force["tokens"]) != {PROCS_FORCED} or min(e[0][1] for e in force["logprobs"]) < -1e-3:
        fail(f"{phase}: the forcing row emitted {sorted(set(force['tokens']))[:5]}")
    for (name, sp), m in zip(rows, mixed):
        n = sp.get("logprobs")
        want = [] if n is None else [1 + min(n, 20)] * PROCS_MAX_TOKENS
        if [len(e) for e in m["logprobs"]] != want:
            fail(f"{phase}: the {name} row carries {len(m['logprobs'])} logprob entries")
    margin = PROCS_MIN_P["temperature"] * math.log(1 / PROCS_MIN_P["min_p"])
    mp = mixed[names.index("min_p")]
    outside = [k for k, e in enumerate(mp["logprobs"]) if e[1][1] - e[0][1] > margin + 1e-4]
    if outside:
        fail(f"{phase}: min_p tokens outside the filter's set at {outside[:5]}")

    # the processed dense reference, over the greedy rows that set a
    # processor or ask for logprobs
    gaps, ranks, randoms, lp_diffs, overlaps = [], [], [], [], []
    for i, (name, sp) in enumerate(rows):
        if name in ("plain", "min_p"):
            continue
        toks = mixed[i]["tokens"]
        raw, ref = processed_reference(torch, engine, prompts[i], toks, sp)
        at = torch.arange(len(toks), device=DEV)
        picked = ref[at, torch.tensor(toks, device=DEV)]
        gaps.append(ref.max(dim=-1).values - picked)
        ranks.append((ref > picked[:, None]).sum(-1))
        # a random token's gap, on the model's own logits (a ban's -1e9
        # would swamp a mean of the processed ones)
        randoms.append(raw.max(dim=-1).values - raw.mean(dim=-1))
        logp = torch.log_softmax(ref, dim=-1)
        got = torch.tensor([e[0][1] for e in mixed[i]["logprobs"]], device=DEV)
        lp_diffs.append((got - logp[at, torch.tensor(toks, device=DEV)]).abs())
        n = min(sp.get("logprobs") or 0, 20)
        if n:
            top = logp.topk(n, dim=-1).indices.tolist()
            overlaps += [len(set(top[k]) & {t for t, _ in e[1:]}) / n
                         for k, e in enumerate(mixed[i]["logprobs"])]
        del raw, ref, logp
    gap, rank = torch.cat(gaps), torch.cat(ranks)
    random_gap = float(torch.cat(randoms).mean())
    reading = {"max_logit_gap": float(gap.max()), "mean_logit_gap": float(gap.mean()),
               "random_token_gap": random_gap, "median_rank": int(rank.median()),
               "max_rank": int(rank.max()), "exact_argmax": int((gap == 0).sum()),
               "tokens": int(gap.numel()),
               "max_logprob_diff": float(torch.cat(lp_diffs).max()),
               "min_top_overlap": min(overlaps), "mean_top_overlap": sum(overlaps) / len(overlaps)}
    moved = [name for i, name in enumerate(names)
             if name in ("repetition", "presence", "frequency")
             and mixed[i]["tokens"] != plain[i]["tokens"]]
    emit({"phase": phase, "model": cfg.name, "rows": names, "max_tokens": PROCS_MAX_TOKENS,
          "wall_s": wall, "penalties_moved_streams": moved,
          "eager_logprob_diff": eager_diff, "launches": counts,
          "limits": {"gap": gap_limit, "median_rank": median_rank_limit,
                     "mean_gap_share": mean_gap_share, "logprob": logprob_limit,
                     "top_overlap": top_overlap_limit},
          **reading, "card": smi})
    checks = (
        (gap_limit, reading["max_logit_gap"] > (gap_limit or 0), "a token's gap below the best"),
        (median_rank_limit, reading["median_rank"] > (median_rank_limit or 0), "median rank"),
        (mean_gap_share, reading["mean_logit_gap"] > (mean_gap_share or 0) * random_gap,
         "mean gap"),
        (logprob_limit, reading["max_logprob_diff"] > (logprob_limit or 0), "logprob"),
        (top_overlap_limit, reading["min_top_overlap"] < (top_overlap_limit or 0),
         "top-N overlap"),
    )
    for limit, over, what in checks:
        if limit is not None and over:
            fail(f"{phase}: the processed dense reference's {what} is past its limit "
                 f"{limit}: {reading}")
    return engine


def variant_costs(torch, runner, smi, phase, ctx_step=25):
    """One decode burst of every slot (profile_phase's) in each variant the
    runner keys a graph by: plain, logprobs, and processors with logprobs
    (half the slots with penalties and a bias, the other half neutral):
    host wall (median of 5, graph replays), device busy a step and device
    ops a step under torch.profiler (which sees the kernels inside a replay:
    the profile phases check it), a replay timed by CUDA events, and the
    processors' and logprobs' cost a step: their busy time beyond the plain
    variant's."""
    import numpy as np

    from dynamo_tpu_torch.ops.logits_process import MAX_BIAS_SLOTS

    S, BS, K = runner.args.max_num_seqs, runner.args.block_size, runner.args.decode_steps
    pos = np.array([100 + ctx_step * i for i in range(S)], np.int32)
    width = int(pos.max() + 2 * K) // BS + 1
    burst = (np.ones(S, np.int32), pos, np.ones(S, np.int32),
             np.arange(S * width, dtype=np.int32).reshape(S, width),
             np.zeros(S, np.float32), np.zeros(S, np.int32), np.ones(S, np.float32),
             np.arange(S, dtype=np.int32))
    half = np.arange(S) % 2 == 0
    bias_ids = np.full((S, MAX_BIAS_SLOTS), -1, np.int32)
    bias_ids[half, :4] = np.arange(4) + 7
    procs = {"minp": np.where(half, 0.05, 0.0).astype(np.float32),
             "rep": np.where(half, 1.2, 1.0).astype(np.float32),
             "pres": np.where(half, 0.5, 0.0).astype(np.float32),
             "freq": np.where(half, 0.3, 0.0).astype(np.float32),
             "bias_ids": bias_ids,
             "bias_vals": np.where(bias_ids >= 0, -2.0, 0.0).astype(np.float32)}
    defaults = runner.args.cuda_graphs
    runner.args.cuda_graphs = True
    out = {}
    for label, want_lp, use_procs in (("plain", False, False), ("logprobs", True, False),
                                      ("procs_logprobs", True, True)):
        def call():
            nb = runner.sync_all(*burst, procs=procs)
            return runner.decode_read(runner.decode_dispatch(nb, want_lp, use_procs))

        call()  # the first use of this key captures its graph
        walls = []
        for _ in range(5):
            t0 = time.monotonic()
            call()
            walls.append(1e3 * (time.monotonic() - t0))
        by_name, n_ops, _, _ = device_times(call)
        busy = sum(by_name.values())
        nb = runner.sync_all(*burst, procs=procs)
        replay_ms = event_ms(torch, runner.graphs[(nb, want_lp, use_procs)].graph.replay)
        out[label] = {"wall_ms": sorted(walls)[2], "device_busy_ms_per_step": busy / K,
                      "replay_event_ms": replay_ms, "device_ops_per_step": n_ops / K}
    runner.args.cuda_graphs = defaults
    torch.cuda.synchronize()
    plain = out["plain"]
    emit({"phase": f"{phase}_variants", "model": runner.config.name, "rows": S, "steps": K,
          "contexts": [int(pos[0]), int(pos[-1])], **out,
          "procs_logprobs_cost_ms_per_step": (out["procs_logprobs"]["device_busy_ms_per_step"]
                                              - plain["device_busy_ms_per_step"]),
          "logprobs_cost_ms_per_step": (out["logprobs"]["device_busy_ms_per_step"]
                                        - plain["device_busy_ms_per_step"]),
          "card": smi})


# The words of the tiny tokenizer's training corpus: prompts made of them
# encode to ids inside its 383, so the streams (at init scale Qwen's tied
# head repeats its input token) decode to text.
PIPELINE_WORDS = ("the quick brown fox jumps over the lazy dog hello world this is a test of "
                  "the tokenizer paged attention continuous batching on tpu hardware 0123456789 "
                  "!@#$%^&*() streaming tokens one at a time over the wire").split()
PIPELINE_MAX_TOKENS = 64


def pipeline_text(tok, rng, n_tokens):
    """Corpus words drawn with ``rng`` until the text encodes to about
    ``n_tokens`` tokens (a word after the first is its own pre-token)."""
    words, n = [], 0
    while n < n_tokens:
        w = PIPELINE_WORDS[int(rng.integers(len(PIPELINE_WORDS)))]
        n += len(tok.encode(w if not words else " " + w))
        words.append(w)
    return " ".join(words)


def pipeline_bodies(tok, stop):
    """The pipeline phase's eight OpenAI bodies: completions and chats of
    100-300 tokens and one completion of about 1,200, greedy, 64 tokens
    each; the second stops at ``stop``, the third asks for logprobs."""
    import numpy as np

    rng = np.random.default_rng(3)
    greedy = dict(model="qwen2.5-0.5b", temperature=0.0, max_tokens=PIPELINE_MAX_TOKENS)
    out = []
    for i, n in enumerate((100, 150, 200, 1200, 120, 180, 250, 300)):
        text = pipeline_text(tok, rng, n)
        body = dict(greedy, prompt=text) if i < 4 or i == 7 else dict(
            greedy, messages=[{"role": "system", "content": "answer briefly"},
                              {"role": "user", "content": text}])
        out.append(body)
    out[1]["stop"] = [stop]
    out[2]["logprobs"] = 3
    return out


async def serve_pipeline(pipeline, bodies):
    """Each body through the pipeline, all at once: per request its items,
    the time it was sent, and (time, tokens) of each item with tokens."""
    from dynamo_tpu_torch.runtime.context import Context

    async def one(body):
        t0, items, stamps = time.monotonic(), [], []
        async for item in pipeline.generate(body, Context()):
            items.append(item)
            if not isinstance(item, dict) and item.token_ids:
                stamps.append((time.monotonic(), len(item.token_ids)))
        return dict(t0=t0, items=items, stamps=stamps)

    return await asyncio.gather(*(one(b) for b in bodies))


async def serve_engine(engine, pres):
    """Each PreprocessedRequest through TorchEngine.generate(), all at once:
    per request its ids, the time it was sent and its (time, tokens)."""
    from dynamo_tpu_torch.runtime.context import Context

    async def one(pre):
        t0, ids, stamps = time.monotonic(), [], []
        async for out in engine.generate(pre, Context()):
            if out.error:
                raise RuntimeError(out.error)
            if out.token_ids:
                stamps.append((time.monotonic(), len(out.token_ids)))
                ids += out.token_ids
        return dict(t0=t0, ids=ids, stamps=stamps)

    return await asyncio.gather(*(one(p) for p in pres))


async def idle_cleared(engine):
    """Wait until the engine has nothing running, waiting or in flight (its
    scheduler reaps the last bursts), then drop its prefix cache, so the
    next run prefills as the first did."""
    def busy():
        st = engine.stats()
        return st["active_seqs"] or st["waiting"] or st["inflight_bursts"]

    while busy():
        await asyncio.sleep(0.005)
    engine.pool.clear()


def latency_ms(runs, itl_rows):
    """In ms over runs with t0 and stamps: TTFT mean and max, ITL mean over
    the runs ``itl_rows`` names, from the first request's send: the last
    request's send, the first and the last first token; then TTFT p50 and
    p99 and ITL p50 and p99 (the value at rank int(q * (n - 1)) sorted)."""
    ttft = [r["stamps"][0][0] - r["t0"] for r in runs]
    itl = [(r["stamps"][-1][0] - r["stamps"][0][0]) / max(sum(n for _, n in r["stamps"]) - 1, 1)
           for r in (runs[i] for i in itl_rows)]
    sent = min(r["t0"] for r in runs)
    first = [r["stamps"][0][0] - sent for r in runs]

    def q(values, p):
        return sorted(values)[int(p * (len(values) - 1))]

    return [1e3 * x for x in (sum(ttft) / len(ttft), max(ttft), sum(itl) / len(itl),
                              max(r["t0"] for r in runs) - sent, min(first), max(first),
                              q(ttft, 0.5), q(ttft, 0.99), q(itl, 0.5), q(itl, 0.99))]


@contextlib.contextmanager
def timed_detokenize():
    """Host time spent in DecodeStream.step / flush (the Backend's
    detokenize) while the block runs, and the tokens fed: {"s", "tokens"}."""
    from dynamo_tpu_torch.llm.tokenizer import DecodeStream

    acc = {"s": 0.0, "tokens": 0}
    step, flush = DecodeStream.step, DecodeStream.flush

    def timed_step(self, token_ids):
        t0 = time.perf_counter()
        try:
            return step(self, token_ids)
        finally:
            acc["s"] += time.perf_counter() - t0
            acc["tokens"] += len(token_ids)

    def timed_flush(self):
        t0 = time.perf_counter()
        try:
            return flush(self)
        finally:
            acc["s"] += time.perf_counter() - t0

    DecodeStream.step, DecodeStream.flush = timed_step, timed_flush
    try:
        yield acc
    finally:
        DecodeStream.step, DecodeStream.flush = step, flush


def qwen_pipeline(on_kv_event=None):
    """(config, engine, tokenizer, card, pipeline, preprocessor) of the
    pipeline phases: build_local_pipeline(card, TorchEngine,
    tiny_tokenizer()) over Qwen2.5-0.5B at the engine's defaults (depth 2,
    CUDA graphs; 16 slots, 2,048 blocks as the engine phases) and its own
    random init (what ``cli run --model qwen2.5-0.5b`` serves); the engine's
    KV events go to ``on_kv_event``."""
    from dynamo_tpu_torch.engines.gpu.engine import TorchEngine, TorchEngineArgs
    from dynamo_tpu_torch.llm import ModelDeploymentCard, OpenAIPreprocessor, tiny_tokenizer
    from dynamo_tpu_torch.llm.entrypoint import build_local_pipeline, resolve_chat_template
    from dynamo_tpu_torch.models.config import qwen2_500m_config

    cfg = qwen2_500m_config()
    args = TorchEngineArgs(config=cfg, block_size=16, num_kv_blocks=2048, max_num_seqs=16,
                           max_model_len=2048, prefill_chunk=512, seed=0, device=DEV)
    engine = TorchEngine(args, on_kv_event=on_kv_event)
    tok = tiny_tokenizer()
    card = ModelDeploymentCard(name=cfg.name, context_length=args.max_model_len,
                               kv_block_size=args.block_size,
                               eos_token_ids=list(cfg.eos_token_ids))
    pipeline = build_local_pipeline(card, engine, tokenizer=tok)
    return cfg, engine, tok, card, pipeline, OpenAIPreprocessor(card, tok,
                                                                resolve_chat_template(card))


def stop_string(tok, ids):
    """Two characters that the stop request's stream reaches, past its
    start."""
    text = tok.decode(ids)
    return next(text[i:i + 2] for i in range(8, len(text) - 1) if text[i:i + 2].strip())


def pipeline_phase(torch, smi) -> dict:
    """Qwen2.5-0.5B text in, text out through ``qwen_pipeline()``. The
    request set is served five times, each from an empty prefix cache: once
    through TorchEngine.generate() to capture every graph it reaches (and
    to give the stop request its stop string), then engine, pipeline,
    pipeline, engine (the engine's own TTFT and ITL beside the pipeline's,
    twice each), launch counts zeroed just before the first pipeline run
    and read just after. Fails unless (a) each
    request's streamed ids are the reference's (the stop request's a
    prefix of them), (b) its text is tokenizer.decode(ids) (the stop
    request's cut before its stop string, finish_reason stop), (c) its
    _prompt_tokens annotation is its prompt's length, (d) both
    paged-attention kernels launched. Returns the launch counts."""
    t_phase = time.monotonic()
    from dynamo_tpu_torch.llm.tokenizer import TINY_TOKENIZER_PATH, HFTokenizer

    cfg, engine, tok, card, pipeline, pre = qwen_pipeline()
    bodies = pipeline_bodies(tok, stop="unset")
    # encoding the ~1,200-token prompt: a fresh tokenizer (empty word cache),
    # then warm (median of 5)
    long_text = bodies[3]["prompt"]
    cold_tok = HFTokenizer.from_file(TINY_TOKENIZER_PATH)
    t0 = time.perf_counter()
    long_ids = cold_tok.encode(long_text)
    encode_cold_ms = 1e3 * (time.perf_counter() - t0)
    warm = []
    for _ in range(5):
        t0 = time.perf_counter()
        cold_tok.encode(long_text)
        warm.append(1e3 * (time.perf_counter() - t0))

    async def run():
        try:
            first = await serve_engine(engine, [pre.preprocess(b) for b in bodies])
            await idle_cleared(engine)
            stop = stop_string(tok, first[1]["ids"])
            measured = pipeline_bodies(tok, stop)
            t0 = time.perf_counter()
            pres = [pre.preprocess(b) for b in measured]
            preprocess_ms = 1e3 * (time.perf_counter() - t0)
            # engine, pipeline, pipeline, engine: each from an empty prefix
            # cache, launches counted over the first pipeline run
            ref = await serve_engine(engine, pres)
            await idle_cleared(engine)
            reset_counts()
            with timed_detokenize() as detok:
                got = await serve_pipeline(pipeline, measured)
            counts = read_counts()
            await idle_cleared(engine)
            got2 = await serve_pipeline(pipeline, measured)
            await idle_cleared(engine)
            ref2 = await serve_engine(engine, pres)
            return stop, measured, pres, preprocess_ms, (ref, ref2), (got, got2), counts, detok
        finally:
            await engine.stop()

    stop, measured, pres, preprocess_ms, refs, gots, counts, detok = asyncio.run(run())
    ref = refs[0]
    if any(a["ids"] != b["ids"] for a, b in zip(*refs)):
        fail("the engine's two runs of the pipeline set gave different ids")
    for got in gots:
        for i, (body, p, r, g) in enumerate(zip(measured, pres, ref, got)):
            ann = [x for x in g["items"] if isinstance(x, dict)]
            outs = [x for x in g["items"] if not isinstance(x, dict)]
            if any(o.error for o in outs):
                fail(f"pipeline request {i} failed: {[o.error for o in outs if o.error]}")
            ids = [t for o in outs for t in o.token_ids]
            text = "".join(o.text for o in outs)
            full = tok.decode(ids)
            reason = outs[-1].finish_reason.value if outs and outs[-1].finish_reason else None
            if ann[:1] != [{"annotation": "_prompt_tokens", "value": len(p.token_ids)}]:
                fail(f"pipeline request {i}: _prompt_tokens annotation {ann[:1]}, expected "
                     f"{len(p.token_ids)}")
            if "stop" in body:
                if ids != r["ids"][:len(ids)] or stop not in full or reason != "stop":
                    fail(f"the stop request's stream ({len(ids)} ids, {reason}) is not a "
                         f"prefix of the engine's ending at its stop string {stop!r}")
                if text != full[:full.index(stop)]:
                    fail(f"the stop request's text {text!r} is not its decoded ids cut "
                         f"before {stop!r}")
                continue
            if ids != r["ids"]:
                at = next((k for k, (a, b) in enumerate(zip(ids, r["ids"])) if a != b), None)
                fail(f"pipeline request {i}: streamed ids part from the engine's generate() "
                     f"at token {at} ({len(ids)} against {len(r['ids'])} ids)")
            if text != full:
                fail(f"pipeline request {i}: text {text!r} is not tokenizer.decode(ids) "
                     f"{full!r}")
            if reason != "length" or len(ids) != PIPELINE_MAX_TOKENS:
                fail(f"pipeline request {i} ended with {len(ids)} tokens ({reason})")
            if body.get("logprobs"):
                entries = [e for o in outs for step in o.logprobs or [] for e in step]
                if len(entries) != 4 * len(ids) or any(
                        e.decoded != tok.decode([e.token_id]) for e in entries):
                    fail("the logprobs request's entries are not 1 + 3 a token with decoded "
                         "strings")
    for name in ("paged_attention_decode", "paged_attention_chunk"):
        if counts[name] <= 0:
            fail(f"{name} never launched on the pipeline path")
    # each run's latency_ms, in the order they ran; ITL over the requests
    # that run to max_tokens at both (the stop request ends early only at
    # the pipeline)
    rows = [i for i, b in enumerate(measured) if "stop" not in b]
    runs = {"engine": latency_ms(refs[0], rows), "pipeline": latency_ms(gots[0], rows),
            "pipeline_2": latency_ms(gots[1], rows), "engine_2": latency_ms(refs[1], rows)}

    def mean(kind, j):
        return (runs[kind][j] + runs[kind + "_2"][j]) / 2

    emit({"phase": "pipeline", "model": cfg.name, "requests": len(measured),
          "max_tokens": PIPELINE_MAX_TOKENS, "prompt_tokens": [len(p.token_ids) for p in pres],
          "stop": stop, "ttft_ms_mean": mean("pipeline", 0), "itl_ms_mean": mean("pipeline", 2),
          "engine_ttft_ms_mean": mean("engine", 0), "engine_itl_ms_mean": mean("engine", 2),
          "runs_ttft_mean_max_itl_sent_first_ms": runs, "preprocess_ms_set": preprocess_ms,
          "detokenize_us_per_token": 1e6 * detok["s"] / max(detok["tokens"], 1),
          "detokenized_tokens": detok["tokens"],
          # at init scale each stream repeats one token (1s here): the
          # detokenize cost above is read on such streams
          "stream_distinct_ids": [len({t for o in g["items"] if not isinstance(o, dict)
                                       for t in o.token_ids}) for g in gots[0]],
          "encode_ms_long_prompt": encode_cold_ms, "encode_ms_long_prompt_warm": sorted(warm)[2],
          "long_prompt_tokens": len(long_ids), "launches": counts,
          "seconds": time.monotonic() - t_phase, "card": smi})
    return counts


def cli_batch_phase(smi) -> None:
    """``python -m dynamo_tpu_torch.cli run --input batch:FILE --model
    qwen2.5-0.5b --max-tokens 32`` as a subprocess on a 4-line JSONL file:
    exit code 0, four JSONL lines with prompt, text, tokens and latency_s,
    and the ``batch done:`` summary on stderr."""
    import tempfile

    import numpy as np

    from dynamo_tpu_torch.llm import tiny_tokenizer

    t_phase = time.monotonic()
    tok, rng = tiny_tokenizer(), np.random.default_rng(4)
    prompts = [pipeline_text(tok, rng, n) for n in (40, 80, 120, 160)]
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as d:
        src = os.path.join(d, "in.jsonl")
        with open(src, "w") as f:
            f.writelines(json.dumps({"prompt": p}) + "\n" for p in prompts)
        t0 = time.monotonic()
        proc = subprocess.run(
            [sys.executable, "-m", "dynamo_tpu_torch.cli", "run", "--input", f"batch:{src}",
             "--model", "qwen2.5-0.5b", "--max-tokens", "32"],
            capture_output=True, text=True, timeout=300, cwd=root)
        wall = time.monotonic() - t0
    if proc.returncode != 0:
        fail(f"cli run exited {proc.returncode}: {proc.stderr[-2000:]}")
    lines = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
    summary = [x for x in proc.stderr.splitlines() if x.startswith("batch done:")]
    if len(lines) != 4 or any(set(x) != {"prompt", "text", "tokens", "latency_s"}
                              for x in lines) or [x["prompt"] for x in lines] != prompts:
        fail(f"cli run printed {len(lines)} JSONL lines, expected 4 with prompt, text, tokens "
             f"and latency_s: {proc.stdout[-2000:]}")
    if not summary:
        fail(f"cli run printed no 'batch done:' summary: {proc.stderr[-2000:]}")
    if any(not 0 < x["tokens"] <= 32 for x in lines):
        fail(f"cli run token counts {[x['tokens'] for x in lines]} outside 1-32")
    emit({"phase": "cli_batch", "model": "qwen2.5-0.5b", "lines": len(lines),
          "tokens": [x["tokens"] for x in lines], "latency_s": [x["latency_s"] for x in lines],
          "text_chars": [len(x["text"]) for x in lines], "summary": summary[-1],
          "wall_s": wall, "seconds": time.monotonic() - t_phase, "card": smi})


HTTP_CLIENT = os.path.join("dynamo_tpu_torch", "tools", "sse_client.py")
HTTP_DISCONNECT_TOKENS = 1024  # the stream the client leaves after 3 frames
# A sample line of the text exposition format 0.0.4.
METRIC_LINE = r'[a-zA-Z_:][a-zA-Z0-9_:]*(\{[a-zA-Z0-9_]+="[^"]*"(,[a-zA-Z0-9_]+="[^"]*")*\})? \S+'


async def http_requests(port, reqs):
    """``reqs`` (tools/sse_client.py's input) sent all at once by that
    client in a process of its own; its records."""
    root = os.path.dirname(os.path.abspath(__file__))
    proc = await asyncio.create_subprocess_exec(
        sys.executable, os.path.join(root, HTTP_CLIENT), str(port),
        stdin=asyncio.subprocess.PIPE, stdout=asyncio.subprocess.PIPE,
        stderr=asyncio.subprocess.PIPE)
    out, err = await asyncio.wait_for(proc.communicate(json.dumps(reqs).encode()), 600)
    if proc.returncode != 0:
        fail(f"the HTTP client exited {proc.returncode}: {err.decode()[-2000:]}")
    return json.loads(out)


def openai_path(body):
    return "/v1/chat/completions" if "messages" in body else "/v1/completions"


def sse_chunks(record):
    """(time, payload) of a streamed response's data frames with choices
    (one a pipeline item), its usage frame's usage, and whether it ended in
    [DONE]."""
    data = [(t, json.loads(f[6:])) for t, f in record["frames"] if f.startswith("data: {")]
    usage = [c["usage"] for _, c in data if not c["choices"]]
    return ([(t, c) for t, c in data if c["choices"]], usage[-1] if usage else None,
            [f for _, f in record["frames"]][-1:] == ["data: [DONE]"])


def choice_text(choice):
    return choice.get("text") or (choice.get("delta") or choice.get("message") or {}).get(
        "content") or ""


def http_latency_ms(records, rows):
    """latency_ms over HTTP streams: TTFT from the request's write to its
    first frame, ITL over the tokens its usage frame counts."""
    runs = []
    for r in records:
        chunks, usage, _ = sse_chunks(r)
        runs.append(dict(t0=r["t0"], stamps=[(chunks[0][0], 1),
                                             (chunks[-1][0], usage["completion_tokens"] - 1)]))
    return latency_ms(runs, rows)


@contextlib.contextmanager
def timed_frames(service_module):
    """Host time spent in the service's ``_sse_send`` (a frame's JSON, its
    chunk and the socket write) while the block runs: {"s", "frames",
    "each"} (``each`` the seconds of every frame).
    (Not the thread's CPU time: ``time.thread_time()`` on the card's
    machine moves in steps of milliseconds.)"""
    acc = {"s": 0.0, "frames": 0, "each": []}
    send = service_module._sse_send

    async def timed(response, payload):
        t0 = time.perf_counter()
        try:
            await send(response, payload)
        finally:
            dt = time.perf_counter() - t0
            acc["s"] += dt
            acc["frames"] += 1
            acc["each"].append(dt)

    service_module._sse_send = timed
    try:
        yield acc
    finally:
        service_module._sse_send = send


# A reader of idle_frame_us's stream in a process of its own.
FRAME_READER = """import socket, sys
s = socket.create_connection(("127.0.0.1", int(sys.argv[1])))
s.sendall(b"POST /frames HTTP/1.1\\r\\nHost: x\\r\\nContent-Length: 0\\r\\n\\r\\n")
tail = b""
while not tail.endswith(b"\\r\\n0\\r\\n\\r\\n"):
    data = s.recv(1 << 16)
    if not data:
        sys.exit(1)
    tail = (tail + data)[-16:]
"""


async def idle_frame_us(frames=2000, batch=50, reader_process=False):
    """µs a frame of the service's ``_sse_send`` with nothing else running:
    one completion chunk sent ``frames`` times on a chunked SSE response
    to a reader on the same loop, which reads between batches of
    ``batch`` frames (untimed): on the card's machine a reader that falls
    a few hundred KB behind stalls the transfer for tens of seconds. With
    ``reader_process`` the reader is FRAME_READER in a process of its own,
    as a served stream's client is."""
    from dynamo_tpu_torch.http import service as http_service
    from dynamo_tpu_torch.http import web
    from dynamo_tpu_torch.llm.protocols.openai import completion_chunk

    out = {}

    async def handler(request):
        resp = web.StreamResponse(headers={"Content-Type": "text/event-stream"})
        await resp.prepare(request)
        chunk = completion_chunk("cmpl-" + "0" * 24, "qwen2.5-0.5b", text="the quick",
                                 finish_reason=None)
        spent = 0.0
        for _ in range(frames // batch):
            t0 = time.perf_counter()
            for _ in range(batch):
                await http_service._sse_send(resp, chunk)
            spent += time.perf_counter() - t0
            await asyncio.sleep(0)
        out["us"] = 1e6 * spent / (frames // batch * batch)
        await resp.write_eof()
        return resp

    app = web.Application()
    app.router.add_post("/frames", handler)
    server = web.Server(app)
    port = await server.start("127.0.0.1", 0)
    if reader_process:
        try:
            proc = await asyncio.create_subprocess_exec(sys.executable, "-c", FRAME_READER,
                                                        str(port))
            if await asyncio.wait_for(proc.wait(), 120):
                fail("the idle frame reader process failed")
        finally:
            await server.stop()
        return out
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        writer.write(b"POST /frames HTTP/1.1\r\nHost: x\r\nContent-Length: 0\r\n\r\n")
        tail = b""
        while not tail.endswith(b"\r\n0\r\n\r\n"):
            data = await asyncio.wait_for(reader.read(1 << 16), 60)
            if not data:
                fail("the idle frame stream ended before its last chunk")
            tail = (tail + data)[-16:]
    finally:
        writer.close()
        await server.stop()
    return out


def http_phase(torch, smi) -> tuple:
    """The OpenAI HTTP frontend over ``qwen_pipeline()``: HttpService on
    127.0.0.1 (the standard-library server of http/web.py), requests sent
    by tools/sse_client.py from a process of its own. The pipeline phase's
    request set is served streamed (usage on) in the order pipeline, http,
    http, pipeline, each from an empty prefix cache, launch counts zeroed
    just before the first HTTP run and read just after; then unary; then n
    2 and /v1/responses (unary and streamed) beside the pipeline serving
    the same engine requests at once; then the error cases, a stream the
    client leaves after three frames, and /metrics. Fails unless every
    text equals the pipeline's for the same body (a completion's frame for
    frame, the logprobs request's tokens the decoded ids), every SSE
    stream ends in [DONE] with usage equal to the prompt's and the
    pipeline's token counts, the error cases get their status codes, the
    departed stream's slot frees before its max_tokens with status 499
    counted, /metrics parses, and both paged-attention kernels launched.
    Returns the launch counts and the streamed set (its requests, each
    one's text and finish reason, the two HTTP runs' records and the rows
    their latencies count), which the mains phase sends again."""
    t_phase = time.monotonic()
    from dynamo_tpu_torch.http import HttpService, ModelManager
    from dynamo_tpu_torch.http import service as http_service

    cfg, engine, tok, card, pipeline, pre = qwen_pipeline()
    steps, last = {}, [t_phase]

    def step(name):
        """Seconds since the previous step, under ``name``."""
        now = time.monotonic()
        steps[name], last[0] = now - last[0], now

    step("engine")

    class Stamped:
        """The pipeline, noting when the service hands it each request."""
        times = []

        def generate(self, request, context):
            self.times.append(time.monotonic())
            return pipeline.generate(request, context)

    manager = ModelManager()
    manager.register(cfg.name, Stamped(), card)
    service = HttpService(manager, host="127.0.0.1", port=0)
    bodies = pipeline_bodies(tok, stop="unset")
    arrivals = []  # ms from each HTTP run's first send to each hand-over

    async def streamed_run(port, reqs):
        Stamped.times = []
        records = await http_requests(port, reqs)
        sent = min(r["t0"] for r in records)
        arrivals.append([1e3 * (t - sent) for t in Stamped.times])
        return records

    async def run():
        port = await service.start()
        try:
            first = await serve_engine(engine, [pre.preprocess(b) for b in bodies])
            await idle_cleared(engine)
            step("capture")
            measured = pipeline_bodies(tok, stop_string(tok, first[1]["ids"]))
            streamed = [{"path": openai_path(b), "body": dict(
                b, stream=True, stream_options={"include_usage": True})} for b in measured]
            # pipeline, http, http, pipeline: each from an empty prefix cache
            got = [await serve_pipeline(pipeline, measured)]
            await idle_cleared(engine)
            reset_counts()
            with timed_frames(http_service) as frames:
                http = [await streamed_run(port, streamed)]
                counts = read_counts()
                await idle_cleared(engine)
                http.append(await streamed_run(port, streamed))
            await idle_cleared(engine)
            got.append(await serve_pipeline(pipeline, measured))
            await idle_cleared(engine)
            step("streamed")
            unary = await http_requests(port, [{"path": openai_path(b), "body": b}
                                               for b in measured])
            await idle_cleared(engine)
            step("unary")
            # n 2 and the Responses API (its chat body, as the service makes
            # it), beside the pipeline serving the same four engine requests
            n2 = dict(measured[0], max_tokens=16)
            said = measured[4]["messages"][1]["content"]
            chat = {"model": cfg.name, "messages": [{"role": "user", "content": said}],
                    "stream": False, "max_tokens": 16, "temperature": 0.0}
            want_x = await serve_pipeline(pipeline, [n2, n2, chat, chat])
            await idle_cleared(engine)
            responses = {"model": cfg.name, "input": said, "max_output_tokens": 16,
                         "temperature": 0.0}
            extras = await http_requests(port, [
                {"path": "/v1/completions", "body": dict(n2, n=2)},
                {"path": "/v1/responses", "body": responses},
                {"path": "/v1/responses", "body": dict(responses, stream=True)}])
            await idle_cleared(engine)
            step("extras")
            errors = await http_requests(port, [
                {"path": "/v1/completions", "body": dict(measured[0], model="nope")},
                {"path": "/v1/completions", "body": dict(measured[0], n=2, stream=True)},
                {"path": "/v1/completions", "raw": "{not json"},
                {"path": "/v1/completions", "body": dict(measured[0], max_tokens=-1,
                                                         stream=True)},
                {"path": "/v1/responses", "body": dict(responses, tools=[{"type": "x"}])}])
            step("errors")
            # a client that leaves after three frames
            before = engine.stats()["generated_tokens"]
            await http_requests(port, [{"path": "/v1/completions", "close_after": 3, "body": dict(
                measured[0], max_tokens=HTTP_DISCONNECT_TOKENS, stream=True)}])
            t0 = time.monotonic()
            while time.monotonic() - t0 < 60:
                st = engine.stats()
                if not (st["active_seqs"] or st["waiting"] or st["inflight_bursts"]):
                    break
                await asyncio.sleep(0.01)
            freed_s = time.monotonic() - t0
            left = engine.stats()
            step("disconnect")
            metrics = (await http_requests(port, [{"method": "GET", "path": "/metrics"}]))[0]
            step("metrics")
            frames["idle"] = await idle_frame_us()
            step("idle_frames")
            return (measured, got, http, unary, n2, want_x, extras, errors, counts, frames,
                    left, left["generated_tokens"] - before, freed_s, metrics)
        finally:
            await service.stop(grace_period=5)
            await engine.stop()
            step("stop")

    (measured, got, http, unary, n2, want_x, extras, errors, counts, frames, left, generated,
     freed_s, metrics) = asyncio.run(run())
    pres = [pre.preprocess(b) for b in measured]

    def outs(run):
        return [x for x in run["items"] if not isinstance(x, dict)]

    def ids(run):
        return [t for o in outs(run) for t in o.token_ids]

    if any(ids(a) != ids(b) for a, b in zip(*got)):
        fail("the pipeline's two runs of the HTTP set gave different ids")
    finished = []  # (text, finish reason) of each request
    for i, (body, p, g) in enumerate(zip(measured, pres, got[0])):
        text, n = "".join(o.text for o in outs(g)), len(ids(g))
        reason = "stop" if "stop" in body else "length"
        finished.append((text, reason))
        want_usage = {"prompt_tokens": len(p.token_ids), "completion_tokens": n,
                      "total_tokens": len(p.token_ids) + n}
        decoded = [tok.decode([t]) for t in ids(g)]
        for run in http:
            r = run[i]
            chunks, usage, done = sse_chunks(r)
            if r["status"] != 200 or not done or usage != want_usage:
                fail(f"HTTP stream {i}: status {r['status']}, [DONE] {done}, usage {usage} "
                     f"(expected {want_usage})")
            texts = [choice_text(c["choices"][0]) for _, c in chunks]
            if "".join(texts) != text or chunks[-1][1]["choices"][0]["finish_reason"] != reason:
                fail(f"HTTP stream {i}: text {''.join(texts)!r} ({chunks[-1][1]['choices']}) "
                     f"is not the pipeline's {text!r} ({reason})")
            if "prompt" in body and texts != [o.text for o in outs(g)]:
                fail(f"HTTP stream {i}: frames {texts} are not the pipeline's items")
            if body.get("logprobs") and [t for _, c in chunks for t in
                                         c["choices"][0]["logprobs"]["tokens"]] != decoded:
                fail(f"HTTP stream {i}: logprob tokens are not the decoded ids")
        r = unary[i]
        doc = json.loads(r["body"])
        if r["status"] != 200 or choice_text(doc["choices"][0]) != text or \
                doc["usage"] != want_usage or doc["choices"][0]["finish_reason"] != reason:
            fail(f"HTTP unary {i}: {r['status']} {r['body'][:500]} is not the pipeline's "
                 f"{text!r} ({want_usage}, {reason})")
        if body.get("logprobs") and doc["choices"][0]["logprobs"]["tokens"] != decoded:
            fail(f"HTTP unary {i}: logprob tokens are not the decoded ids")
    # n 2, /v1/responses unary and streamed
    n2_texts = ["".join(o.text for o in outs(g)) for g in want_x[:2]]
    said_text = "".join(o.text for o in outs(want_x[2]))
    doc = json.loads(extras[0]["body"])
    if [c["text"] for c in doc["choices"]] != n2_texts or doc["usage"]["completion_tokens"] != \
            sum(len(ids(g)) for g in want_x[:2]):
        fail(f"n 2: {extras[0]['body'][:500]} is not the pipeline's {n2_texts}")
    doc = json.loads(extras[1]["body"])
    if doc["status"] != "completed" or doc["output"][0]["content"][0]["text"] != said_text or \
            doc["usage"]["output_tokens"] != len(ids(want_x[2])):
        fail(f"/v1/responses: {extras[1]['body'][:500]} is not the pipeline's {said_text!r}")
    events = [(f.split("\n")[0][len("event: "):], json.loads(f.split("\n")[1][6:]))
              for _, f in extras[2]["frames"]]
    deltas = "".join(e["delta"] for k, e in events if k == "response.output_text.delta")
    if [k for k, _ in events[:1] + events[-2:]] != [
            "response.created", "response.output_text.done", "response.completed"] or \
            deltas != said_text or events[-1][1]["response"]["usage"]["output_tokens"] != \
            len(ids(want_x[3])):
        fail(f"/v1/responses streamed: {[k for k, _ in events]} {deltas!r} is not the "
             f"pipeline's {said_text!r}")
    statuses = [r["status"] for r in errors]
    if statuses != [404, 400, 400, 400, 501]:
        fail(f"error cases answered {statuses}, expected [404, 400, 400, 400, 501]")
    # the departed client, /metrics
    samples = {}
    for line in metrics["body"].splitlines():
        if line and not line.startswith("#"):
            if not re.fullmatch(METRIC_LINE, line):
                fail(f"/metrics line does not parse: {line!r}")
            name, value = line.rsplit(" ", 1)
            samples[name] = float(value)
    gone = samples.get('dynamo_tpu_frontend_requests_total{model="qwen2.5-0.5b",'
                       'endpoint="completions",status="499"}')
    if left["active_seqs"] or left["waiting"] or generated >= HTTP_DISCONNECT_TOKENS or gone != 1:
        fail(f"the stream the client left did not free its slot: {left['active_seqs']} active, "
             f"{generated} tokens generated (max_tokens {HTTP_DISCONNECT_TOKENS}), "
             f"499 counted {gone}")
    for name in ("paged_attention_decode", "paged_attention_chunk"):
        if counts[name] <= 0:
            fail(f"{name} never launched on the HTTP path")
    rows = [i for i, b in enumerate(measured) if "stop" not in b]
    runs = {"pipeline": latency_ms(got[0], rows), "http": http_latency_ms(http[0], rows),
            "http_2": http_latency_ms(http[1], rows), "pipeline_2": latency_ms(got[1], rows)}

    def mean(kind, j):
        return (runs[kind][j] + runs[kind + "_2"][j]) / 2

    emit({"phase": "http", "model": cfg.name, "requests": len(measured),
          "max_tokens": PIPELINE_MAX_TOKENS, "ttft_ms_mean": mean("http", 0),
          "itl_ms_mean": mean("http", 2), "pipeline_ttft_ms_mean": mean("pipeline", 0),
          "pipeline_itl_ms_mean": mean("pipeline", 2),
          "runs_ttft_mean_max_itl_sent_first_ms": runs,
          "sse_send_us_per_frame": 1e6 * frames["s"] / max(frames["frames"], 1),
          "sse_send_idle_us_per_frame": frames["idle"]["us"],
          "sse_frames": frames["frames"],
          # when the service handed each request to the pipeline, from the
          # run's first send (the pipeline phase hands all of them over at
          # once)
          "handover_ms_first_last": [[min(a), max(a)] for a in arrivals],
          "disconnect_freed_s": freed_s,
          "disconnect_tokens": generated, "launches": counts, "step_seconds": steps,
          "seconds": time.monotonic() - t_phase, "card": smi})
    streamed = [{"path": openai_path(b), "body": dict(b, stream=True, stream_options={
        "include_usage": True})} for b in measured]
    return counts, {"requests": streamed, "texts": finished, "records": http, "rows": rows}


def frame_probe(torch, smi) -> None:
    """``python3 chip_smoke.py --frame-probe``: why a frame of the service's
    ``_sse_send`` costs several times more while the engine serves than
    alone. HttpService over ``qwen_pipeline()`` on 127.0.0.1, in four
    rounds under the interpreter's switch interval (``sys.setswitchinterval``)
    at its default 5 ms and at 0.1 ms, in the order default, short, short,
    default. Each round: the http phase's streamed set from the client
    process (µs a frame of ``_sse_send`` while serving, TTFT, ITL), then
    ``idle_frame_us`` with the engine idle (its scheduler thread parked)
    and again while the pipeline serves the same set in-process (the
    scheduler thread dispatching; no HTTP request is open), each in
    batches of 50 frames and one frame a loop turn (as a served stream
    sends them, with other work between), and parked once more to a
    reader in a process of its own (a served stream's reader is the
    client's process, which each send may have to wake). The served
    frames' quantiles and the share of their time in frames over 1 ms tell
    a few long waits (for the GIL, which a thread waiting for it asks for
    after one switch interval) from every frame costing more; the served
    frames' ``json.dumps`` is timed apart from the rest. Fails unless
    every stream ends in [DONE] with status 200. One line a round; no
    result line."""
    from dynamo_tpu_torch.http import HttpService, ModelManager
    from dynamo_tpu_torch.http import service as http_service

    cfg, engine, tok, card, pipeline, pre = qwen_pipeline()
    manager = ModelManager()
    manager.register(cfg.name, pipeline, card)
    service = HttpService(manager, host="127.0.0.1", port=0)
    default = sys.getswitchinterval()

    class TimedJson:
        """The service module's ``json``, timing ``dumps`` (a frame's
        payload; a streamed run calls nothing else of it)."""
        acc = {"s": 0.0, "calls": 0, "bytes": 0}

        def __getattr__(self, name):
            return getattr(json, name)

        def dumps(self, *a, **k):
            t0 = time.perf_counter()
            out = json.dumps(*a, **k)
            self.acc["s"] += time.perf_counter() - t0
            self.acc["calls"] += 1
            self.acc["bytes"] += len(out)
            return out

    async def run():
        port = await service.start()
        try:
            first = await serve_engine(engine, [pre.preprocess(b) for b in
                                                pipeline_bodies(tok, stop="unset")])
            await idle_cleared(engine)
            measured = pipeline_bodies(tok, stop_string(tok, first[1]["ids"]))
            streamed = [{"path": openai_path(b), "body": dict(
                b, stream=True, stream_options={"include_usage": True})} for b in measured]
            rows = [i for i, b in enumerate(measured) if "stop" not in b]
            for interval in (default, 1e-4, 1e-4, default):
                sys.setswitchinterval(interval)
                TimedJson.acc = {"s": 0.0, "calls": 0, "bytes": 0}
                http_service.json = TimedJson()
                try:
                    with timed_frames(http_service) as frames:
                        records = await http_requests(port, streamed)
                finally:
                    http_service.json = json
                dumps = TimedJson.acc
                await idle_cleared(engine)
                bad = [r["status"] for r in records if r["status"] != 200 or not sse_chunks(r)[2]]
                if bad:
                    fail(f"frame probe: streams answered {bad} or ended without [DONE]")
                parked = await idle_frame_us()
                parked_1 = await idle_frame_us(frames=500, batch=1)
                parked_p = await idle_frame_us(reader_process=True)
                serving = asyncio.ensure_future(serve_pipeline(pipeline, measured))
                while not engine.stats()["active_seqs"]:
                    await asyncio.sleep(0.001)
                t0 = time.monotonic()
                dispatching = await idle_frame_us()
                dispatching_1 = await idle_frame_us(frames=500, batch=1)
                overlapped = engine.stats()["active_seqs"] > 0
                took = time.monotonic() - t0
                await serving
                await idle_cleared(engine)
                lat = http_latency_ms(records, rows)
                each = sorted(frames["each"])
                slow = [t for t in each if t > 1e-3]
                emit({"phase": "frame_probe", "switch_interval_s": interval,
                      "sse_send_us_per_frame_serving": 1e6 * frames["s"] / max(frames["frames"], 1),
                      "sse_frames": frames["frames"],
                      "sse_send_us_p50_p90_p99_max": [
                          1e6 * each[min(int(q * len(each)), len(each) - 1)]
                          for q in (0.5, 0.9, 0.99, 1.0)],
                      "sse_frames_over_1ms": len(slow),
                      "json_dumps_us_per_call_serving": 1e6 * dumps["s"] / max(dumps["calls"], 1),
                      "json_dumps_calls": dumps["calls"],
                      "json_bytes_per_call": dumps["bytes"] / max(dumps["calls"], 1),
                      "sse_send_share_in_frames_over_1ms": sum(slow) / max(frames["s"], 1e-12),
                      "ttft_ms_mean": lat[0],
                      "itl_ms_mean": lat[2], "idle_us_per_frame_parked": parked["us"],
                      "idle_us_per_frame_dispatching": dispatching["us"],
                      "idle_us_per_frame_parked_one_a_turn": parked_1["us"],
                      "idle_us_per_frame_dispatching_one_a_turn": dispatching_1["us"],
                      "idle_us_per_frame_parked_reader_process": parked_p["us"],
                      "dispatching_read_s": took,
                      "engine_still_serving_at_its_end": overlapped, "card": smi})
        finally:
            sys.setswitchinterval(default)
            await service.stop(grace_period=5)
            await engine.stop()

    asyncio.run(run())


def cli_http_phase(smi) -> None:
    """``python -m dynamo_tpu_torch.cli run --input http --model
    qwen2.5-0.5b --http-port 0`` as a subprocess: its ``http server on
    :PORT`` line, one streamed chat (SSE ending in [DONE]) and one unary
    completion, then SIGINT, after which it must end within 15 s."""
    import http.client
    import select
    import signal
    import tempfile

    t_phase = time.monotonic()
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryFile("w+") as errf:
        proc = subprocess.Popen(
            [sys.executable, "-m", "dynamo_tpu_torch.cli", "run", "--input", "http", "--model",
             "qwen2.5-0.5b", "--http-port", "0"],
            stdout=subprocess.PIPE, stderr=errf, text=True, cwd=root)
        try:
            line = ""
            if select.select([proc.stdout], [], [], 300)[0]:
                line = proc.stdout.readline()
            m = re.fullmatch(r"http server on :(\d+) serving qwen2\.5-0\.5b\n", line)
            if not m:
                errf.seek(0)
                fail(f"cli run --input http printed {line!r}: {errf.read()[-2000:]}")
            startup_s = time.monotonic() - t_phase

            def post(body):
                conn = http.client.HTTPConnection("127.0.0.1", int(m.group(1)), timeout=120)
                conn.request("POST", openai_path(body), json.dumps(body),
                             {"Content-Type": "application/json"})
                r = conn.getresponse()
                out = r.status, r.read().decode()
                conn.close()
                return out

            base = {"model": "qwen2.5-0.5b", "max_tokens": 32, "temperature": 0.0}
            t0 = time.monotonic()
            status, sse = post(dict(base, messages=[{"role": "user", "content": "hello world"}],
                                    stream=True))
            chat_s = time.monotonic() - t0
            frames = [f for f in sse.split("\n\n") if f]
            if status != 200 or frames[-1] != "data: [DONE]" or len(frames) < 3:
                fail(f"cli run --input http: streamed chat {status} {sse[-1000:]!r}")
            status, raw = post(dict(base, prompt="the quick brown fox jumps"))
            doc = json.loads(raw)
            if status != 200 or not 0 < doc["usage"]["completion_tokens"] <= 32:
                fail(f"cli run --input http: completion {status} {raw[-1000:]!r}")
            proc.send_signal(signal.SIGINT)
            t0 = time.monotonic()
            try:
                proc.wait(timeout=15)
            except subprocess.TimeoutExpired:
                fail("cli run --input http did not end within 15 s of SIGINT")
            stop_s = time.monotonic() - t0
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    emit({"phase": "cli_http", "model": "qwen2.5-0.5b", "startup_s": startup_s,
          "chat_frames": len(frames), "chat_s": chat_s,
          "completion_tokens": doc["usage"]["completion_tokens"], "sigint_exit_s": stop_s,
          "returncode": proc.returncode, "seconds": time.monotonic() - t_phase, "card": smi})


# -- the distributed runtime's planes across processes ----------------------

RUNTIME_EVENTS = 2000  # events the worker publishes at once on one topic
RUNTIME_PACED_EVENTS = 200  # then one a RUNTIME_EVENT_GAP_S: the unloaded latency
RUNTIME_EVENT_GAP_S = 0.001
RUNTIME_EVENT_TOPIC = "dynamo.backend.kv_events"
RUNTIME_LONG_TOKENS = 1500  # the cancelled and the killed streams' max_tokens
RUNTIME_START_S = 300.0  # the worker's start, its engine built


@contextlib.contextmanager
def timed_codec():
    """Host time of the request plane's frames in this process while the
    block runs: FrameWriter.send's whole call (pack, write, and its drain,
    which waits only while the socket's buffer is past its high-water mark)
    and FrameReader.recv's read and unpack, from its length prefix's
    arrival. The codec's own methods run unchanged: the clock is read
    around send, and, in recv, where it unpacks the prefix (codec._LEN) and
    where it returns."""
    import contextvars

    from dynamo_tpu_torch.runtime.network import codec

    acc = {"send_s": 0.0, "send_n": 0, "recv_s": 0.0, "recv_n": 0}
    arrived = contextvars.ContextVar("frame_prefix_arrived")  # one a task
    length, send, recv = codec._LEN, codec.FrameWriter.send, codec.FrameReader.recv

    class Prefix:  # codec._LEN, reading the clock as recv unpacks a prefix
        size, pack = length.size, length.pack

        @staticmethod
        def unpack(data):
            arrived.set(time.perf_counter())
            return length.unpack(data)

    async def timed_send(self, header, payload=None):
        t0 = time.perf_counter()
        await send(self, header, payload)
        acc["send_s"] += time.perf_counter() - t0
        acc["send_n"] += 1

    async def timed_recv(self):
        got = await recv(self)
        if got is not None:
            acc["recv_s"] += time.perf_counter() - arrived.get()
            acc["recv_n"] += 1
        return got

    codec._LEN, codec.FrameWriter.send, codec.FrameReader.recv = Prefix, timed_send, timed_recv
    try:
        yield acc
    finally:
        codec._LEN, codec.FrameWriter.send, codec.FrameReader.recv = length, send, recv


def runtime_worker() -> int:
    """The worker role of the runtime_tcp and kv_router phases
    (``--runtime-worker [--instance-id N] [--kv-publish]``): a test harness,
    not the worker main (ROADMAP A4c-3). TorchEngine for Qwen2.5-0.5B as
    qwen_pipeline() builds it, served on dynamo/backend/generate through
    DistributedRuntime.from_settings() under instance N (default 1), and a
    control endpoint: stats (engine.stats(), the kernel launch counts and
    the frames' host time), reset (counts, frame times and event times to
    0), clear (wait until idle, drop the prefix cache), engine_run (the
    given requests through engine.generate() in-process, then clear),
    publish (a run of events on one topic through the runtime's event
    plane), committed (pool.committed_view()) and kv_events (the KV events
    published so far, and when each was emitted). With --kv-publish a
    router.publisher.KvEventPublisher takes the engine's KV events
    (on_kv_event) and answers snapshot requests (committed_view), and a
    LoadPublisher reports engine.stats(). Ends on SIGTERM."""
    import signal

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke --runtime-worker: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.backends.cuda.matmul.allow_tf32 = False
    from dynamo_tpu_torch.router import KvEventPublisher, LoadPublisher
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

    argv = sys.argv[2:]
    instance_id = int(argv[argv.index("--instance-id") + 1]) if "--instance-id" in argv else 1
    kv_publish = "--kv-publish" in argv

    async def run():
        runtime = DistributedRuntime.from_settings()
        publisher, load, emitted = None, None, {}  # event id -> monotonic ns at emission
        on_kv_event = None
        if kv_publish:
            publisher = KvEventPublisher(runtime.event_plane, "dynamo", "backend", instance_id)

            def on_kv_event(event):
                publisher.on_kv_event(event)
                emitted[publisher._event_id] = time.monotonic_ns()

        _, engine, _, _, _, _ = qwen_pipeline(on_kv_event=on_kv_event)
        if kv_publish:
            publisher.set_snapshot_fn(engine.pool.committed_view)
            load = LoadPublisher(runtime.event_plane, "dynamo", "backend", instance_id,
                                 engine.stats)
            load.start()
        stop = asyncio.Event()
        asyncio.get_running_loop().add_signal_handler(signal.SIGTERM, stop.set)
        with timed_codec() as frames:
            async def control(request, context):
                op = request.get("op")
                if op == "stats":
                    yield dict(engine.stats(), launches=read_counts(), frames=dict(frames))
                elif op == "reset":
                    reset_counts()
                    frames.update(send_s=0.0, send_n=0, recv_s=0.0, recv_n=0)
                    emitted.clear()
                    yield {"ok": True}
                elif op == "clear":
                    await idle_cleared(engine)
                    yield {"ok": True}
                elif op == "engine_run":
                    runs = await serve_engine(engine, request["requests"])
                    await idle_cleared(engine)
                    yield {"runs": runs}
                elif op == "publish":
                    for i in range(request["start"], request["start"] + request["n"]):
                        await runtime.event_plane.publish(request["topic"], runtime_event(i))
                        if request["gap_s"]:
                            await asyncio.sleep(request["gap_s"])
                    yield {"published": request["n"]}
                elif op == "committed":
                    yield {"committed": [list(e) for e in engine.pool.committed_view()]}
                elif op == "kv_events":
                    yield {"published": publisher._event_id if publisher else 0,
                           "emitted_ns": sorted(emitted.items())}
                else:
                    yield {"error": f"unknown control op {op!r}"}

            component = runtime.namespace("dynamo").component("backend")
            await component.endpoint("generate").serve_endpoint(engine.generate,
                                                                instance_id=instance_id)
            await component.endpoint("control").serve_endpoint(control,
                                                               instance_id=instance_id)
            try:
                await stop.wait()
            finally:
                if kv_publish:
                    await load.close()
                    await publisher.close()
                await runtime.shutdown(grace_period=1)
                await runtime.event_plane.close()
                await engine.stop()

    asyncio.run(run())
    return 0


def runtime_event(i):
    """The i-th event of the worker's run: a KV-event-like record with
    64-bit block hashes and the publish time on the host's monotonic clock
    (one clock for both processes of one machine)."""
    return {"event_id": i, "t_ns": time.monotonic_ns(),
            "block_hashes": [(i * 4 + k) * 0x9E3779B97F4A7C15 % 2 ** 64 for k in range(4)],
            "parent_hash": None if i == 0 else (i * 4 - 1) * 0x9E3779B97F4A7C15 % 2 ** 64}


async def serve_tcp(client, pres):
    """Each PreprocessedRequest through the runtime's Client (over TCP), all
    at once: per request its ids, the time it was sent and its (time,
    tokens), as serve_engine gives them in-process."""
    from dynamo_tpu_torch.runtime.context import Context

    async def one(pre):
        t0, ids, stamps = time.monotonic(), [], []
        async for out in client.generate(pre, Context()):
            if out["error"]:
                raise RuntimeError(out["error"])
            if out["token_ids"]:
                stamps.append((time.monotonic(), len(out["token_ids"])))
                ids += out["token_ids"]
        return dict(t0=t0, ids=ids, stamps=stamps)

    return await asyncio.gather(*(one(p) for p in pres))


def runtime_tcp_phase(smi) -> dict:
    """Phase 33 (see the module's docstring). Returns the worker's launch
    counts over the first TCP run."""
    import select
    import tempfile

    t_phase = time.monotonic()
    root = os.path.dirname(os.path.abspath(__file__))
    from dynamo_tpu_torch.llm import ModelDeploymentCard, OpenAIPreprocessor, tiny_tokenizer
    from dynamo_tpu_torch.llm.entrypoint import resolve_chat_template
    from dynamo_tpu_torch.runtime.context import Context
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.runtime.events.zmq_plane import replay_events
    from dynamo_tpu_torch.runtime.network.tcp import StreamDisconnectedError

    tok = tiny_tokenizer()
    card = ModelDeploymentCard(name="qwen2.5-0.5b", context_length=2048, kv_block_size=16)
    pre = OpenAIPreprocessor(card, tok, resolve_chat_template(card))
    steps, last = {}, [t_phase]

    def step(name):
        now = time.monotonic()
        steps[name], last[0] = now - last[0], now

    procs = []
    with tempfile.TemporaryDirectory() as tmp, \
            open(os.path.join(tmp, "discd.err"), "w+") as discd_err, \
            open(os.path.join(tmp, "worker.log"), "w+") as worker_log:
        try:
            discd = subprocess.Popen(
                [sys.executable, "-m", "dynamo_tpu_torch.discd", "--port", "0", "--xsub", "0",
                 "--xpub", "0", "--events-log", os.path.join(tmp, "events.log"),
                 "--replay-port", "0"],
                stdout=subprocess.PIPE, stderr=discd_err, text=True, cwd=root)
            procs.append(discd)
            line = discd.stdout.readline() if select.select([discd.stdout], [], [], 60)[0] else ""
            m = re.fullmatch(r"discd ready: discovery (\S+), events (\S+), replay :(\d+)\n", line)
            if not m:
                discd_err.seek(0)
                fail(f"discd printed {line!r}: {discd_err.read()[-2000:]}")
            env = {"DYN_TPU_DISCOVERY": "discd", "DYN_TPU_DISCOVERY_ADDR": m.group(1),
                   "DYN_TPU_REQUEST_PLANE": "tcp", "DYN_TPU_EVENT_PLANE": "zmq",
                   "DYN_TPU_EVENT_PLANE_ADDR": m.group(2)}
            replay_host, replay_port = m.group(2).split(":")[0], int(m.group(3))
            worker = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--runtime-worker"],
                stdout=worker_log, stderr=subprocess.STDOUT, cwd=root, env={**os.environ, **env})
            procs.append(worker)
            step("discd_worker_spawn")

            def worker_tail():
                worker_log.seek(0)
                return worker_log.read()[-3000:]

            saved = {k: os.environ.get(k) for k in env}
            os.environ.update(env)
            try:
                result = asyncio.run(runtime_client(
                    DistributedRuntime, Context, StreamDisconnectedError, replay_events,
                    pre, tok, worker, worker_tail, replay_host, replay_port, step))
            finally:
                for k, v in saved.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.terminate()
                    try:
                        proc.wait(timeout=15)
                    except subprocess.TimeoutExpired:
                        proc.kill()
                        proc.wait()
            if procs:
                procs[0].stdout.close()
    measured, refs, tcps, counts, worker_frames, recv_frames, lat_us, cancel, killed = result
    rows = [i for i, b in enumerate(measured) if "stop" not in b]
    runs = {"engine": latency_ms(refs[0], rows), "tcp": latency_ms(tcps[0], rows),
            "tcp_2": latency_ms(tcps[1], rows), "engine_2": latency_ms(refs[1], rows)}

    def mean(kind, j):
        return (runs[kind][j] + runs[kind + "_2"][j]) / 2

    burst, paced = sorted(lat_us["burst"]), sorted(lat_us["paced"])
    emit({"phase": "runtime_tcp", "model": "qwen2.5-0.5b", "requests": len(measured),
          "planes": {"discovery": "discd", "request": "tcp", "events": "zmq (ZMTP)"},
          "ttft_ms_mean": mean("tcp", 0), "itl_ms_mean": mean("tcp", 2),
          "engine_ttft_ms_mean": mean("engine", 0), "engine_itl_ms_mean": mean("engine", 2),
          "runs_ttft_mean_max_itl_sent_first_ms": runs,
          "worker_send_us_per_frame": 1e6 * worker_frames["send_s"] / max(worker_frames["send_n"], 1),
          "worker_frames_sent": worker_frames["send_n"],
          "client_recv_us_per_frame": 1e6 * recv_frames["recv_s"] / max(recv_frames["recv_n"], 1),
          "client_frames_read": recv_frames["recv_n"],
          "events_burst": RUNTIME_EVENTS, "events_burst_s": lat_us["burst_s"],
          "event_us_p50": burst[len(burst) // 2],
          "event_us_p99": burst[int(0.99 * (len(burst) - 1))],
          "events_paced": RUNTIME_PACED_EVENTS, "event_gap_s": RUNTIME_EVENT_GAP_S,
          "event_us_p50_paced": paced[len(paced) // 2],
          "event_us_p99_paced": paced[int(0.99 * (len(paced) - 1))],
          "cancel": cancel, "killed_worker": killed, "launches": counts, "steps_s": steps,
          "seconds": time.monotonic() - t_phase, "card": smi})
    return counts


async def runtime_client(DistributedRuntime, Context, StreamDisconnectedError, replay_events,
                         pre, tok, worker, worker_tail, replay_host, replay_port, step):
    """The client side of runtime_tcp_phase, in this process's own loop."""
    runtime = DistributedRuntime.from_settings()
    ns = runtime.namespace("dynamo").component("backend")
    gen = await ns.endpoint("generate").client()
    ctl = await ns.endpoint("control").client()
    try:
        deadline = time.monotonic() + RUNTIME_START_S
        while not (gen.instance_ids and ctl.instance_ids):
            if worker.poll() is not None:
                fail(f"the runtime worker exited {worker.returncode}: {worker_tail()}")
            if time.monotonic() > deadline:
                fail(f"no worker instance in discd after {RUNTIME_START_S} s: {worker_tail()}")
            await asyncio.sleep(0.1)
        step("worker_registered")

        async def control(op, **kw):
            items = [x async for x in ctl.generate({"op": op, **kw}, Context())]
            if len(items) != 1 or "error" in items[0]:
                fail(f"control {op}: {items}")
            return items[0]

        bodies = pipeline_bodies(tok, stop="unset")
        first = (await control("engine_run", requests=[pre.preprocess(b).to_dict()
                                                       for b in bodies]))["runs"]
        step("capture")
        measured = pipeline_bodies(tok, stop_string(tok, first[1]["ids"]))
        pres = [pre.preprocess(b).to_dict() for b in measured]
        # in-process, tcp, tcp, in-process: each from an empty prefix cache
        refs = [(await control("engine_run", requests=pres))["runs"]]
        await control("reset")
        with timed_codec() as recv_frames:
            tcps = [await serve_tcp(gen, pres)]
            stats = await control("stats")
            await control("clear")
            tcps.append(await serve_tcp(gen, pres))
        await control("clear")
        refs.append((await control("engine_run", requests=pres))["runs"])
        step("runs")
        counts, worker_frames = stats["launches"], stats["frames"]
        for r in refs[1:] + tcps:
            for i, (a, b) in enumerate(zip(refs[0], r)):
                if a["ids"] != b["ids"]:
                    at = next((k for k, (x, y) in enumerate(zip(a["ids"], b["ids"])) if x != y),
                              None)
                    fail(f"runtime_tcp request {i}: ids part from the in-process run's at "
                         f"token {at} ({len(b['ids'])} against {len(a['ids'])})")
        if any(len(r["ids"]) != PIPELINE_MAX_TOKENS for r in refs[0]):
            fail(f"runtime_tcp: streams of {[len(r['ids']) for r in refs[0]]} ids")
        for name in ("paged_attention_decode", "paged_attention_chunk"):
            if counts[name] <= 0:
                fail(f"{name} never launched in the worker on the runtime_tcp path")

        # events: a burst and then a paced run on one topic through the
        # broker, in order, and again from the broker's log
        sub = runtime.event_plane.subscribe(RUNTIME_EVENT_TOPIC)
        await asyncio.sleep(0.5)  # the subscription reaches the broker
        got, lat_us = [], {}
        for leg, n, gap in (("burst", RUNTIME_EVENTS, 0.0),
                            ("paced", RUNTIME_PACED_EVENTS, RUNTIME_EVENT_GAP_S)):
            t0 = time.monotonic()
            pub_task = asyncio.ensure_future(control(
                "publish", topic=RUNTIME_EVENT_TOPIC, start=len(got), n=n, gap_s=gap))
            lat_us[leg] = []
            for _ in range(n):
                topic, payload = await sub.get(timeout=30)
                lat_us[leg].append((time.monotonic_ns() - payload["t_ns"]) / 1e3)
                got.append(payload)
            await pub_task
            lat_us[leg + "_s"] = time.monotonic() - t0
        await sub.aclose()
        if [p["event_id"] for p in got] != list(range(len(got))) or any(
                p["block_hashes"] != runtime_event(p["event_id"])["block_hashes"] for p in got):
            fail("runtime_tcp: the events arrived out of order or changed")
        replayed = await replay_events(replay_host, replay_port, timeout_s=30)
        if [(s, t, p) for s, t, p in replayed] != [
                (i + 1, RUNTIME_EVENT_TOPIC, p) for i, p in enumerate(got)]:
            fail(f"runtime_tcp: the broker's log replays {len(replayed)} events, not the "
                 f"{len(got)} received")
        step("events")

        # a cancel mid-stream frees the worker's slot: cold, when the
        # graphs of the width buckets (table widths) that no earlier run met
        # are captured inside the cancelled stream's bursts, then warm
        long = dict(pres[0], stop=dict(pres[0]["stop"], max_tokens=RUNTIME_LONG_TOKENS))

        async def cancel_one():
            await control("clear")
            st0 = await control("stats")
            ctx, n_items = Context(), 0
            async for out in gen.generate(long, ctx):
                n_items += 1
                if n_items == 3:
                    ctx.stop_generating()
                    break
            t0, polls = time.monotonic(), []
            while True:
                t1 = time.monotonic()
                st = await control("stats")
                # (ms since the cancel, ms the stats call took, slots held, tokens)
                polls.append((1e3 * (t1 - t0), 1e3 * (time.monotonic() - t1),
                              st["active_seqs"], st["generated_tokens"] - st0["generated_tokens"]))
                if not (st["active_seqs"] or st["waiting"]):
                    break
                if time.monotonic() - t0 > 30:
                    fail(f"runtime_tcp: the cancelled stream's slot is still held: {st}")
                await asyncio.sleep(0.01)
            one = {"items_read": n_items,
                   "tokens_generated": st["generated_tokens"] - st0["generated_tokens"],
                   "slot_freed_s": time.monotonic() - t0, "polls": len(polls),
                   "first_polls": polls[:4], "last_poll": polls[-1],
                   "graphs_captured": st["decode_graphs"] - st0["decode_graphs"],
                   "graph_capture_ms": st["graph_capture_ms"] - st0["graph_capture_ms"]}
            if one["tokens_generated"] >= RUNTIME_LONG_TOKENS:
                fail(f"runtime_tcp: the cancelled stream ran to its end: {one}")
            return one

        cancel = {"cold": await cancel_one()}
        cancel["warm"] = await cancel_one()
        step("cancel")

        # a killed worker surfaces StreamDisconnectedError
        n_items, err, t0 = 0, None, time.monotonic()
        try:
            async for out in gen.generate(long, Context()):
                n_items += 1
                if n_items == 3:
                    worker.kill()
                    t0 = time.monotonic()
        except StreamDisconnectedError as exc:
            err = exc
        if err is None:
            fail(f"runtime_tcp: the killed worker's stream ended without "
                 f"StreamDisconnectedError after {n_items} items")
        killed = {"items_read": n_items, "disconnect_s": time.monotonic() - t0,
                  "error": repr(err)}
        worker.wait(timeout=30)
        killed["reaped_s"] = time.monotonic() - t0  # the worker's exit seen here
        step("kill")
        return (measured, refs, tcps, counts, worker_frames, recv_frames, lat_us, cancel,
                killed)
    finally:
        await gen.close()
        await ctl.close()
        await runtime.shutdown(grace_period=1)
        await runtime.event_plane.close()


KV_GROUPS = 6  # prefix groups of the kv_router phase
KV_GROUP_SIZE = 4  # requests a group: the first alone, then the rest at once
KV_PREFIX_TOKENS = 1024  # a group's shared prefix: 64 blocks of 16
KV_SUFFIX_TOKENS = (32, 200)  # each request's own suffix, drawn in this range
KV_MAX_TOKENS = 64
KV_BLOCK = 16
KV_LOAD_INTERVAL_S = 0.2  # the workers' load reports (DYN_TPU_LOAD_REPORT_INTERVAL_S)
KV_WAIT_S = 30.0
KV_RUNS = itertools.count()  # kv_router_phase calls in this process
# compute_block_hashes over HASH_TOKENS at block sizes 16 and 64, salt 0 and
# adapter_salt("lora-a"): the numbers the xxhash library gives (the JAX
# package's hashes; tests/test_torch_xxh3.py checks them against xxhash).
HASH_TOKENS = [(i * 7919 + 13) % 151_936 for i in range(256)]
HASH_CONSTANTS = {
    (16, None): [
        0x6457135A0E1D3D32, 0xBDBF74D598907BCA, 0x84C869D9DB18DB9F, 0xD393573E4B83E7A9,
        0xD9BED3636D25265C, 0xF85F8C8574B3DBB1, 0xBB4F3C9044BDF1CB, 0x37438E800081189D,
        0x8CBF6C747E78E6A0, 0x50D22281D92EB2CF, 0x61762EE5C756D9FF, 0x5E250D22BABF0707,
        0xE0BD1A6F121A5395, 0xDC26FB50077D8BAA, 0x8CC157CBE8474BD2, 0xB9EB20D0530C2279],
    (16, "lora-a"): [
        0x10A829C66ADF5EF6, 0xED420B1929DA3491, 0x2C33CEFF2D6B86AB, 0xD14DDDC11B7E072E,
        0x4BD0481A1E91EEA0, 0x79C4BA0DD7A43B7A, 0x6FE1CCDAA8ADA107, 0x01F7AAB55CAFDC3A,
        0xA3B72D7178FE7A14, 0x9709C625F7A0B7C0, 0xEA2CE97BAEC68606, 0xE377C1E17875F361,
        0x5AADA9309219EDD7, 0x9AAE6EF4781EDD5A, 0x567C0F3DB5A89AE6, 0x45C44CB00A2A2082],
    (64, None): [0xFE157634774E2DB6, 0xB885957BA37A1210, 0x12DE7FD69306119A,
                 0x1918360F98A60918],
    (64, "lora-a"): [0x1479FBB0674BB281, 0x595730FA2361C836, 0x8A9ED8AD43B0F75D,
                     0x3492C153A05537D3],
}


def kv_requests(run: int):
    """The kv_router phase's request set: KV_GROUPS groups of KV_GROUP_SIZE
    preprocessed greedy requests; a group's requests share a
    KV_PREFIX_TOKENS-token prefix and each adds its own suffix. The ids
    name the phase's run: the router's lifecycle ring, which tells where
    each request went, outlives a run."""
    import numpy as np

    from dynamo_tpu_torch.llm.protocols.common import (
        PreprocessedRequest, SamplingOptions, StopConditions,
    )

    rng = np.random.default_rng(2024)
    groups = []
    for g in range(KV_GROUPS):
        prefix = rng.integers(3, 150_000, KV_PREFIX_TOKENS).tolist()
        groups.append([PreprocessedRequest(
            token_ids=prefix + rng.integers(3, 150_000, int(rng.integers(
                KV_SUFFIX_TOKENS[0], KV_SUFFIX_TOKENS[1] + 1))).tolist(),
            request_id=f"kv{run}-{g}-{i}", sampling=SamplingOptions(temperature=0.0),
            stop=StopConditions(max_tokens=KV_MAX_TOKENS, ignore_eos=True),
        ).to_dict() for i in range(KV_GROUP_SIZE)])
    return groups


def check_hash_constants() -> float:
    """The port's block hashes against HASH_CONSTANTS; returns host µs a
    64-byte block (16 tokens) over a 1,024-token list."""
    from dynamo_tpu_torch.tokens.blocks import adapter_salt, compute_block_hashes

    for (block, lora), want in HASH_CONSTANTS.items():
        got = compute_block_hashes(HASH_TOKENS, block, salt=adapter_salt(lora))
        if got != want:
            fail(f"kv_router: compute_block_hashes at block size {block}, adapter {lora!r} "
                 f"is not xxh3-64's: {[hex(h) for h in got[:2]]}")
    tokens = list(range(1000, 1000 + KV_PREFIX_TOKENS))
    t0 = time.perf_counter()
    for _ in range(10):
        compute_block_hashes(tokens, KV_BLOCK)
    return 1e6 * (time.perf_counter() - t0) / (10 * KV_PREFIX_TOKENS // KV_BLOCK)


def kv_router_phase(smi) -> dict:
    """Phase 34 (see the module's docstring). Returns the launch counts of
    both workers over the KV-routed run, summed."""
    import select
    import tempfile

    t_phase = time.monotonic()
    root = os.path.dirname(os.path.abspath(__file__))
    hash_us = check_hash_constants()
    procs = []
    with tempfile.TemporaryDirectory() as tmp, \
            open(os.path.join(tmp, "discd.err"), "w+") as discd_err:
        logs = [open(os.path.join(tmp, f"worker{i}.log"), "w+") for i in (1, 2)]
        try:
            discd = subprocess.Popen(
                [sys.executable, "-m", "dynamo_tpu_torch.discd", "--port", "0", "--xsub", "0",
                 "--xpub", "0"], stdout=subprocess.PIPE, stderr=discd_err, text=True, cwd=root)
            procs.append(discd)
            line = discd.stdout.readline() if select.select([discd.stdout], [], [], 60)[0] else ""
            m = re.fullmatch(r"discd ready: discovery (\S+), events (\S+)(, replay :\d+)?\n", line)
            if not m:
                discd_err.seek(0)
                fail(f"discd printed {line!r}: {discd_err.read()[-2000:]}")
            env = {"DYN_TPU_DISCOVERY": "discd", "DYN_TPU_DISCOVERY_ADDR": m.group(1),
                   "DYN_TPU_REQUEST_PLANE": "tcp", "DYN_TPU_EVENT_PLANE": "zmq",
                   "DYN_TPU_EVENT_PLANE_ADDR": m.group(2),
                   "DYN_TPU_LOAD_REPORT_INTERVAL_S": str(KV_LOAD_INTERVAL_S)}
            workers = []
            for i, log in zip((1, 2), logs):
                workers.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "--runtime-worker",
                     "--instance-id", str(i), "--kv-publish"],
                    stdout=log, stderr=subprocess.STDOUT, cwd=root, env={**os.environ, **env}))
            procs += workers

            def worker_tail(i):
                logs[i - 1].seek(0)
                return logs[i - 1].read()[-3000:]

            saved = {k: os.environ.get(k) for k in env}
            os.environ.update(env)
            try:
                result = asyncio.run(kv_router_client(workers, worker_tail))
            finally:
                for k, v in saved.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.terminate()
                    try:
                        proc.wait(timeout=15)
                    except subprocess.TimeoutExpired:
                        proc.kill()
                        proc.wait()
            if procs:
                procs[0].stdout.close()
            for log in logs:
                log.close()
    counts = result.pop("launches")
    summed = {n: sum(c.get(n, 0) for c in counts.values()) for n in counts[1]}
    emit({"phase": "kv_router", "model": "qwen2.5-0.5b", "workers": 2,
          "requests": KV_GROUPS * KV_GROUP_SIZE, "prefix_tokens": KV_PREFIX_TOKENS,
          "block_size": KV_BLOCK, "hash_us_per_64B_block": hash_us, **result,
          "launches": {str(w): {n: c[n] for n in ("paged_attention_decode",
                                                   "paged_attention_chunk")}
                       for w, c in counts.items()},
          "seconds": time.monotonic() - t_phase, "card": smi})
    return summed


async def kv_router_client(workers, worker_tail):
    """The frontend side of kv_router_phase, in this process's own loop: a
    RouterMode.KV client with a KvRouter attached, a ROUND_ROBIN client
    beside it, and the workers' control endpoints."""
    from dynamo_tpu_torch.router import KvRouter
    from dynamo_tpu_torch.runtime import lifecycle
    from dynamo_tpu_torch.runtime.component import RouterMode
    from dynamo_tpu_torch.runtime.context import Context
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

    t_start = time.monotonic()
    runtime = DistributedRuntime.from_settings()
    comp = runtime.namespace("dynamo").component("backend")
    kv = await comp.endpoint("generate").client(RouterMode.KV)
    rr = await comp.endpoint("generate").client(RouterMode.ROUND_ROBIN)
    ctl = await comp.endpoint("control").client()
    routers = []
    try:
        deadline = time.monotonic() + RUNTIME_START_S
        while not all(set(c.instance_ids) == {1, 2} for c in (kv, rr, ctl)):
            for i, w in enumerate(workers, 1):
                if w.poll() is not None:
                    fail(f"kv_router: worker {i} exited {w.returncode}: {worker_tail(i)}")
            if time.monotonic() > deadline:
                fail(f"kv_router: the workers did not register in {RUNTIME_START_S} s: "
                     f"{worker_tail(1)} {worker_tail(2)}")
            await asyncio.sleep(0.1)
        t_up = time.monotonic()

        async def control(op, wid, **kw):
            items = [x async for x in ctl.direct({"op": op, **kw}, wid, Context())]
            if len(items) != 1 or "error" in items[0]:
                fail(f"kv_router: control {op} on worker {wid}: {items}")
            return items[0]

        router = KvRouter(runtime, "dynamo", "backend", block_size=KV_BLOCK)
        applied_ns = {}  # (worker, event id) -> monotonic ns when the index took it
        apply = router.indexer.apply

        def timed_apply(event):
            apply(event)
            applied_ns[(event.worker_id, event.event_id)] = time.monotonic_ns()

        router.indexer.apply = timed_apply
        await router.start()
        routers.append(router)
        router.attach(kv)
        await asyncio.sleep(0.5)  # the router's subscriptions reach the publishers

        async def published():
            return {w: (await control("kv_events", w))["published"] for w in (1, 2)}

        # Quiesce: the index has every event the workers published so far;
        # from here each later event is applied once, so counts add up.
        async def quiesce():
            pub = await published()
            for _ in range(int(KV_WAIT_S / 0.01)):
                if all(router.indexer._last_event_id.get((w, 0), 0) >= n
                       for w, n in pub.items()):
                    return router.indexer.events_applied - sum(pub.values())
                await asyncio.sleep(0.01)
            fail(f"kv_router: the router's index lags the workers' events: {pub}, "
                 f"{router.indexer._last_event_id}")

        async def all_applied(base):
            await router.wait_for_events(base + sum((await published()).values()), KV_WAIT_S)

        async def idle_at(worker):
            for _ in range(int(KV_WAIT_S / 0.01)):
                if router.scheduler.load_view().get(worker, (1,))[0] == 0:
                    return
                await asyncio.sleep(0.01)
            fail(f"kv_router: the router never saw {worker} idle: "
                 f"{router.scheduler.load_view()}")

        groups = kv_requests(next(KV_RUNS))
        flat = [r for g in groups for r in g]
        # Graph capture at the phase's width bucket in both workers, then
        # empty caches and zeroed counts.
        for w in (1, 2):
            await control("engine_run", w, requests=[groups[0][0]])
            await control("reset", w)

        async def one(client, req):
            t0, ids, stamps = time.monotonic(), [], []
            async for out in client.generate(dict(req), Context()):
                if out["error"]:
                    raise RuntimeError(out["error"])
                if out["token_ids"]:
                    stamps.append((time.monotonic(), len(out["token_ids"])))
                    ids += out["token_ids"]
            return dict(t0=t0, ids=ids, stamps=stamps)

        def routed(req):
            tl = lifecycle.global_lifecycle().get(req["request_id"])
            ev = [e for e in tl.events if e.name == "routed"] if tl else []
            return (ev[-1].attrs["worker"], ev[-1].attrs["overlap_blocks"]) if ev else None

        async def run_groups(client, base):
            """Each group's first request alone among its group; once its KV
            events are in the index and the router sees its worker idle,
            the rest of the group at once, and beside them the next group's
            first request. Returns each request's run, in request order."""
            runs, pending = {}, []

            async def keep(req):
                runs[req["request_id"]] = await one(client, req)

            for g, group in enumerate(groups):
                await keep(group[0])
                if client is kv:
                    await all_applied(base)
                    await idle_at((routed(group[0])[0], 0))
                pending += [asyncio.ensure_future(keep(r)) for r in group[1:]]
                if client is kv:  # the followers are routed before the next first
                    while any(routed(r) is None for r in group[1:]):
                        await asyncio.sleep(0.001)
                else:
                    await asyncio.sleep(0.01)
            await asyncio.gather(*pending)
            return [runs[r["request_id"]] for r in flat]

        modes = {}
        for name, client in (("kv", kv), ("round_robin", rr)):
            for w in (1, 2):
                await control("clear", w)
            base = await quiesce()
            st0 = {w: await control("stats", w) for w in (1, 2)}
            t0 = time.monotonic()
            runs = await run_groups(client, base)
            wall = time.monotonic() - t0
            st1 = {w: await control("stats", w) for w in (1, 2)}
            prefill = {w: st1[w]["prefill_tokens"] - st0[w]["prefill_tokens"] for w in (1, 2)}
            ttft = [1e3 * (r["stamps"][0][0] - r["t0"]) for r in runs]
            itl = [1e3 * (r["stamps"][-1][0] - r["stamps"][0][0]) / (len(r["ids"]) - 1)
                   for r in runs]
            modes[name] = dict(
                runs=runs, prefill=prefill, launches=st1, wall_s=wall,
                line={"prefix_hit_blocks": (sum(len(r["token_ids"]) for r in flat)
                                            - sum(prefill.values())) / KV_BLOCK,
                      "prefill_tokens": prefill, "ttft_ms_mean": sum(ttft) / len(ttft),
                      "ttft_ms_max": max(ttft), "itl_ms_mean": sum(itl) / len(itl),
                      "first_requests_ttft_ms_mean": sum(ttft[::KV_GROUP_SIZE]) / KV_GROUPS,
                      "followers_ttft_ms_mean": (sum(ttft) - sum(ttft[::KV_GROUP_SIZE]))
                      / (len(ttft) - KV_GROUPS), "wall_s": wall})
            if name == "kv":
                await all_applied(base)
                first_workers = {}
                # the router's predictions against the workers' own matches
                expect = {1: 0, 2: 0}
                for g, group in enumerate(groups):
                    first_w, first_overlap = routed(group[0])
                    if first_overlap != 0:
                        fail(f"kv_router: group {g}'s first request predicted {first_overlap} "
                             f"blocks of overlap")
                    for r in group[1:]:
                        if routed(r) != (first_w, KV_PREFIX_TOKENS // KV_BLOCK):
                            fail(f"kv_router: {r['request_id']} went to {routed(r)}, not to "
                                 f"worker {first_w} with {KV_PREFIX_TOKENS // KV_BLOCK} blocks")
                    for r in group:
                        w, overlap = routed(r)
                        expect[w] += len(r["token_ids"]) - KV_BLOCK * overlap
                    first_workers[group[0]["request_id"]] = first_w
                if set(first_workers.values()) != {1, 2}:
                    fail(f"kv_router: the cold first requests all went to one worker: "
                         f"{first_workers}")
                if prefill != expect:
                    fail(f"kv_router: the workers prefilled {prefill} tokens, the router "
                         f"predicted {expect}")
                # the index holds exactly each worker's committed blocks
                held = {}
                for w in (1, 2):
                    committed = {h for h, _ in (await control("committed", w))["committed"]}
                    held[w] = set(router.indexer.tree._worker_blocks.get((w, 0), ()))
                    if held[w] != committed or not committed:
                        fail(f"kv_router: the index holds {len(held[w])} blocks of worker {w}, "
                             f"which has {len(committed)} committed "
                             f"({len(held[w] ^ committed)} differ)")
                if set(router.scheduler.load_view()) != {(1, 0), (2, 0)}:
                    fail(f"kv_router: the scheduler's load view is "
                         f"{router.scheduler.load_view()}")
                # a fresh router rebuilds the index from the snapshots alone
                fresh = KvRouter(runtime, "dynamo", "backend", block_size=KV_BLOCK)
                t_fresh = time.monotonic()
                await fresh.start()
                routers.append(fresh)
                await fresh.wait_for_events(2, KV_WAIT_S)
                resync_s = time.monotonic() - t_fresh
                for w in (1, 2):
                    got = set(fresh.indexer.tree._worker_blocks.get((w, 0), ()))
                    if got != held[w]:
                        fail(f"kv_router: the fresh router's index holds {len(got)} blocks of "
                             f"worker {w}, not {len(held[w])}")
                # host time a decision, on the fresh router's index
                t0 = time.perf_counter()
                for r in flat:
                    fresh.find_best_match(r["token_ids"], [(1, 0), (2, 0)])
                match_us = 1e6 * (time.perf_counter() - t0) / len(flat)
                await fresh.stop()
                routers.remove(fresh)
                ev = await asyncio.gather(*(control("kv_events", w) for w in (1, 2)))
                lat = sorted((applied_ns[(w, i)] - t) / 1e3 for w, e in zip((1, 2), ev)
                             for i, t in e["emitted_ns"] if (w, i) in applied_ns)
                kv_stats = dict(
                    index_blocks={str(w): len(held[w]) for w in (1, 2)},
                    resync_s=resync_s, find_best_match_us=match_us,
                    event_us_p50=lat[len(lat) // 2], event_us_p99=lat[int(0.99 * (len(lat) - 1))],
                    events_timed=len(lat), events_applied=router.indexer.events_applied,
                    decisions={r: router.metrics.decisions.value(reason=r) for r in (
                        "kv_overlap", "load_only", "pinned", "fallback", "no_worker")},
                    first_request_workers=first_workers)

        # every stream against the same requests in-process on worker 1
        ref = (await control("engine_run", 1, requests=flat))["runs"]
        for name, mode in modes.items():
            for r, a, b in zip(flat, ref, mode["runs"]):
                if a["ids"] != b["ids"] or len(a["ids"]) != KV_MAX_TOKENS:
                    at = next((k for k, (x, y) in enumerate(zip(a["ids"], b["ids"])) if x != y),
                              None)
                    fail(f"kv_router ({name}): {r['request_id']}'s ids part from the "
                         f"in-process run's at token {at} ({len(b['ids'])} against "
                         f"{len(a['ids'])})")
        launches = {w: modes["kv"]["launches"][w]["launches"] for w in (1, 2)}
        for w in (1, 2):
            for n in ("paged_attention_decode", "paged_attention_chunk"):
                if launches[w][n] <= 0:
                    fail(f"kv_router: {n} never launched in worker {w} on the KV-routed run")
        return {"kv": modes["kv"]["line"], "round_robin": modes["round_robin"]["line"],
                **kv_stats, "workers_up_s": t_up - t_start, "launches": launches}
    finally:
        for r in routers:
            await r.stop()
        for c in (kv, rr, ctl):
            await c.close()
        await runtime.shutdown(grace_period=1)
        await runtime.event_plane.close()


# -- the worker and frontend mains across processes --------------------------

MAINS_WORKERS = (0x101, 0x202)  # the two workers' DYN_TPU_WORKER_ID
MAINS_MODEL = "qwen2.5-0.5b"
MAINS_GROUPS = 3  # prefix groups: a leader alone, then its followers at once
MAINS_GROUP_SIZE = 3
MAINS_PREFIX_TOKENS = 1024  # a group's shared prefix: 64 blocks of 16
MAINS_MAX_TOKENS = 16  # each pin and prefix-group request's tokens
MAINS_LONG_TOKENS = 1500  # the migrated stream's max_tokens
MAINS_KILL_AFTER = 100  # tokens the client has read when its worker is killed
MAINS_INTERVAL_S = 0.2  # load reports, and the interval liveness judges them by
MAINS_DEAD_AFTER = 4  # missed intervals before liveness declares a worker dead
MAINS_GRACE_S = 10.0  # every process's DYN_TPU_GRACE_PERIOD
MAINS_WAIT_S = 30.0  # the longest any one step of the phase may wait
# The overload phase inside the deployment: two more frontend mains on the
# same discd, one with small caps, one with an ITL SLA no decode can meet.
OVERLOAD_CAPS = {"DYN_TPU_OVERLOAD_MAX_CONCURRENCY": "4", "DYN_TPU_OVERLOAD_MAX_QUEUE": "4"}
OVERLOAD_SLA = {"DYN_TPU_OVERLOAD_ITL_SLA_MS": "0.5"}
OVERLOAD_BURST = 24  # concurrent streams at the caps frontend: 4 run, 4 queue, 16 shed
OVERLOAD_TOKENS = 256  # each burst stream's tokens (ignore_eos): none ends before the last arrives
OVERLOAD_CLAMPED = 512  # the request the browned-out frontend clamps to its 256
OVERLOAD_DEADLINE_MS = 300  # the pinned request that waits behind a full engine
# Each of the 16 streams that fill that engine's slots: long enough (4 s
# and more) that all 16 still run when the expired request is shed, which
# the engine does at its deadline, with no slot free.
OVERLOAD_FILL_TOKENS = 1024
OVERLOAD_WARM_S = 1.5  # the fillers' first pass outlasts the measured one by this
TRACEPARENT = "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01"
# The system part inside the deployment: the worker main that serves its
# system server (the one whose decode buckets the overload part warmed).
SYSTEM_WORKER = MAINS_WORKERS[0]
SYSTEM_TRACEPARENT = "00-5c0ffee0d15ea5e0ba5eba11deadbeef-1a2b3c4d5e6f7a8b-01"
SYSTEM_PROFILE_S = 2.0  # the bounded torch.profiler capture
# The capture runs while the worker decodes this many OVERLOAD_FILL_TOKENS
# streams (and the request below): the profiler records every kernel of
# every replayed burst (some 1,400 a token at Qwen2.5-0.5B), and the stop
# turns each into a trace event, tens of µs apiece, without the worker's
# GIL and with its engine's device thread parked (the streams pause). /live,
# polled every SYSTEM_LIVE_POLL_S through the capture and its stop, must
# answer within MAINS_INTERVAL_S, and liveness declares nothing.
SYSTEM_PROFILE_LOAD = 15
SYSTEM_LIVE_POLL_S = 0.02
# The request sent inside the capture: 2 prefill chunks (the second runs the
# chunk kernel), then its first token and one decode burst, replayed.
SYSTEM_PROFILE_PROMPT = 600
SYSTEM_PROFILE_TOKENS = 2
SYSTEM_SCRAPES = 50  # timed scrapes of each SYSTEM_SCRAPED route while a stream runs
SYSTEM_SCRAPED = ("/metrics", "/debug/memory", "/debug/perf", "/debug/compiles")
SYSTEM_SCRAPE_S = 0.1  # the scrape interval of the ITL comparison
SYSTEM_ITL_STREAMS = 4  # concurrent 256-token streams a run of the ITL comparison
HBM_CATEGORIES = ("kv_cache", "params", "slot_state", "slot_tables", "lora", "proc_state")
# The migrated stream is held token for token: up to the failure against
# the same request run unbroken on the survivor, and after it against its
# witness, the request Migration built (the prompt with the carried tokens,
# max_tokens less those) run on the survivor from an empty cache, as the
# migrated request ran there: both re-prefill the carried tokens in one
# chunk and decode from that KV. The unbroken run decoded those tokens
# instead, so past the failure its KV rounds apart in bf16 and its stream
# may part from the migrated one (on an H100, 1,104 tokens after the
# kill, PERF.md section 6): that parting is printed, not held.


def mains_worker() -> int:
    """The worker role of the mains phase (``--mains-worker COUNTS_FILE
    ARGS...``): ``dynamo_tpu_torch.worker.__main__.main()`` unchanged, on
    ARGS, with the kernel launch counts (zeroed as the process starts)
    written to COUNTS_FILE every 0.25 s and when main() returns — a
    SIGKILLed worker leaves its last write — and beside them the CUDA
    caching allocator's bytes in use to COUNTS_FILE.alloc (null before the
    process made its CUDA context). It adds no endpoint and no control op."""
    import threading

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    out = sys.argv[2]
    sys.argv = [sys.argv[0]] + sys.argv[3:]
    from dynamo_tpu_torch.worker import __main__ as worker

    import torch

    reset_counts()
    done = threading.Event()

    def dump():
        alloc = (torch.cuda.memory_stats()["allocated_bytes.all.current"]
                 if torch.cuda.is_initialized() else None)
        for path, doc in ((out, read_counts()), (out + ".alloc", alloc)):
            with open(path + ".tmp", "w") as f:
                json.dump(doc, f)
            os.replace(path + ".tmp", path)

    def every_quarter_second():
        while not done.wait(0.25):
            dump()

    writer = threading.Thread(target=every_quarter_second, daemon=True)
    writer.start()
    try:
        asyncio.run(worker.main())
    finally:
        done.set()
        writer.join()  # one writer of the file at a time
        dump()
    return 0


class ProcLines:
    """A child process's merged output, read by a thread: each line with
    the monotonic time it arrived."""

    def __init__(self, proc):
        import threading

        self.proc, self.lines = proc, []
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self):
        for line in self.proc.stdout:
            self.lines.append((time.monotonic(), line))

    def find(self, pattern, since=None):
        """(arrival time, match) of the first line matching (that arrived
        after ``since``), or None."""
        for t, line in list(self.lines):
            m = re.search(pattern, line)
            if m and (since is None or t > since):
                return t, m
        return None

    def tail(self, n=3000):
        return "".join(line for _, line in list(self.lines))[-n:]

    def alarms(self, n=12):
        """The last ``n`` WARNING, ERROR and CRITICAL log lines."""
        return [line.strip() for _, line in list(self.lines)
                if re.search(r" (WARNING|ERROR|CRITICAL) ", line)][-n:]


async def until(what, fn, timeout=MAINS_WAIT_S, procs=()):
    """Poll ``fn()`` (sync or async) until it is truthy; fail after
    ``timeout`` or when a process of ``procs`` has exited."""
    t0 = time.monotonic()
    while True:
        got = fn()
        if asyncio.iscoroutine(got):
            got = await got
        if got:
            return got
        for name, p in procs:
            if p.proc.poll() is not None:
                fail(f"mains: {name} exited {p.proc.returncode} while waiting for {what}: "
                     f"{p.tail()}")
        if time.monotonic() - t0 > timeout:
            fail(f"mains: {what} not within {timeout} s: "
                 + " | ".join(f"{n}: {p.tail(1500)}" for n, p in procs))
        await asyncio.sleep(0.02)


def mains_phase(smi, http_set) -> dict:
    """Phase 35 (see the module's docstring). Returns the two workers'
    launch counts, summed."""
    import tempfile

    t_phase = time.monotonic()
    root = os.path.dirname(os.path.abspath(__file__))
    procs = {}
    with tempfile.TemporaryDirectory() as tmp:
        try:
            procs["discd"] = ProcLines(subprocess.Popen(
                [sys.executable, "-m", "dynamo_tpu_torch.discd", "--port", "0", "--xsub", "0",
                 "--xpub", "0"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                cwd=root))
            t0 = time.monotonic()
            while not procs["discd"].find(r"discd ready"):
                if procs["discd"].proc.poll() is not None or time.monotonic() - t0 > 60:
                    fail(f"mains: discd did not start: {procs['discd'].tail()}")
                time.sleep(0.02)
            m = procs["discd"].find(r"discd ready: discovery (\S+), events (\S+)")[1]
            # tests/test_e2e_processes.py's cluster env, with the crash plane's
            # intervals short; the lease TTL stays at its default (10 s) so
            # that the killed worker's card leaves discd within the phase
            env = {**os.environ, "PYTHONUNBUFFERED": "1", "DYN_TPU_DISCOVERY": "discd",
                   "DYN_TPU_DISCOVERY_ADDR": m.group(1), "DYN_TPU_EVENT_PLANE": "zmq",
                   "DYN_TPU_EVENT_PLANE_ADDR": m.group(2), "DYN_TPU_REQUEST_PLANE": "tcp",
                   "DYN_TPU_LOAD_REPORT_INTERVAL_S": str(MAINS_INTERVAL_S),
                   "DYN_TPU_LIVENESS_INTERVAL_S": str(MAINS_INTERVAL_S),
                   "DYN_TPU_LIVENESS_DEAD_AFTER": str(MAINS_DEAD_AFTER),
                   "DYN_TPU_GRACE_PERIOD": str(MAINS_GRACE_S)}
            env.pop("DYN_TPU_LEASE_TTL", None)
            t_spawn = time.monotonic()
            counts_files = {}
            # the system worker's perf ledger persists its fingerprints here
            # at its SIGTERM (it is the survivor of the migration below)
            fingerprints = os.path.join(tmp, "fingerprints.json")
            for wid in MAINS_WORKERS:
                counts_files[wid] = os.path.join(tmp, f"counts-{wid:x}.json")
                procs[f"worker {wid:#x}"] = ProcLines(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "--mains-worker",
                     counts_files[wid], "--model", MAINS_MODEL,
                     *(["--system-port", "0"] if wid == SYSTEM_WORKER else [])],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=root,
                    env={**env, "DYN_TPU_WORKER_ID": str(wid),
                         **({"DYN_TPU_PERF_FINGERPRINT_PATH": fingerprints}
                            if wid == SYSTEM_WORKER else {})}))
            for name, extra in (("frontend", {}), ("frontend caps", OVERLOAD_CAPS),
                                ("frontend sla", OVERLOAD_SLA)):
                procs[name] = ProcLines(subprocess.Popen(
                    [sys.executable, "-m", "dynamo_tpu_torch.frontend", "--host", "127.0.0.1",
                     "--http-port", "0"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True, cwd=root, env={**env, **extra}))
            saved = {k: os.environ.get(k) for k in env if k.startswith("DYN_TPU_")}
            os.environ.update({k: env[k] for k in saved})
            try:
                result = asyncio.run(mains_client(procs, t_spawn, http_set,
                                                  counts_files[SYSTEM_WORKER], fingerprints))
            finally:
                for k, v in saved.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
        finally:
            for p in reversed(list(procs.values())):
                if p.proc.poll() is None:
                    p.proc.terminate()
                    try:
                        p.proc.wait(timeout=15)
                    except subprocess.TimeoutExpired:
                        p.proc.kill()
                        p.proc.wait()
        counts = {}
        for wid, path in counts_files.items():
            with open(path) as f:
                counts[wid] = json.load(f)
    for wid, c in counts.items():
        for n in ("paged_attention_decode", "paged_attention_chunk"):
            if c[n] <= 0:
                fail(f"mains: {n} never launched in worker {wid:#x}")
    emit({"phase": "overload", "model": MAINS_MODEL, **result.pop("overload"), "card": smi})
    emit({"phase": "system", "model": MAINS_MODEL, "worker": hex(SYSTEM_WORKER),
          **result.pop("system"), "card": smi})
    emit({"phase": "mains", "model": MAINS_MODEL, "workers": [hex(w) for w in MAINS_WORKERS],
          **result, "launches": {hex(w): {n: c[n] for n in (
              "paged_attention_decode", "paged_attention_chunk")} for w, c in counts.items()},
          "seconds": time.monotonic() - t_phase, "card": smi})
    return {n: sum(c.get(n, 0) for c in counts.values()) for n in counts[MAINS_WORKERS[0]]}


async def mains_client(procs, t_spawn, http_set, counts_file, fingerprints) -> dict:
    """The client side of mains_phase: HTTP to the frontend process, and
    the workers' ``control`` endpoints (stats, clear_kv_blocks) through
    the runtime's planes; ``counts_file`` is the system worker's, and
    ``fingerprints`` the file its perf ledger stores at its SIGTERM."""
    import signal
    from types import SimpleNamespace

    import numpy as np

    from dynamo_tpu_torch.llm import tiny_tokenizer
    from dynamo_tpu_torch.llm.entrypoint import resolve_chat_template, resolve_tokenizer
    from dynamo_tpu_torch.llm.migration import _carry_tokens
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.runtime.context import Context
    from dynamo_tpu_torch.runtime.discovery import instance_prefix
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.tools import sse_client

    steps, last = {}, [time.monotonic()]

    def step(name):
        now = time.monotonic()
        steps[name], last[0] = now - last[0], now

    workers = {wid: procs[f"worker {wid:#x}"] for wid in MAINS_WORKERS}
    frontend = procs["frontend"]
    everyone = list(procs.items())  # the processes that must stay up
    startup = asyncio.ensure_future(system_startup(workers[SYSTEM_WORKER], everyone))
    port = int((await until("the frontend's listening line", lambda: frontend.find(
        r"frontend listening on \S+:(\d+)"), procs=everyone))[1].group(1))

    async def http(req, on_frame=None):
        return await asyncio.wait_for(sse_client.one(port, req, on_frame), MAINS_WAIT_S * 4)

    async def get(path):
        return await http({"method": "GET", "path": path})

    async def post(path, body, pin=None):
        return await http({"path": path, "body": body,
                           "headers": {} if pin is None else {"x-dynamo-worker": str(pin)}})

    # -- discovery --------------------------------------------------------
    served = []
    for wid, w in workers.items():
        served.append((await until(f"worker {wid:#x}'s serving line", lambda w=w, wid=wid: w.find(
            rf"worker serving {MAINS_MODEL} as dynamo/backend/generate instance {wid:#x} "
            r"incarnation 0x[0-9a-f]+"), timeout=300, procs=everyone))[0])

    async def listed():
        return [m["id"] for m in json.loads((await get("/v1/models"))["body"])["data"]]

    await until("the model on /v1/models", lambda: _is(listed(), [MAINS_MODEL]),
                procs=everyone)
    t_listed = time.monotonic()
    step("registration")

    runtime = DistributedRuntime.from_settings()
    backend = runtime.namespace("dynamo").component("backend")
    ctl = await backend.endpoint("control").client()
    gen = await backend.endpoint("generate").client()
    try:
        await until("both workers' control endpoints",
                    lambda: set(ctl.instance_ids) == set(MAINS_WORKERS))

        async def stats(wid):
            items = [x async for x in ctl.direct({"op": "stats"}, wid, Context())]
            if len(items) != 1 or "error" in items[0]:
                fail(f"mains: stats of worker {wid:#x}: {items}")
            return items[0]

        async def all_stats(alive=MAINS_WORKERS):
            return {w: await stats(w) for w in alive}

        async def idle(alive=MAINS_WORKERS):
            s = await all_stats(alive)
            return all(not (x["active_seqs"] or x["waiting"] or x["inflight_bursts"])
                       for x in s.values())

        async def clear():
            await until("idle workers", lambda: idle(live), procs=everyone)
            r = await post("/clear_kv_blocks", {})
            if r["status"] != 200:
                fail(f"mains: /clear_kv_blocks answered {r['status']} {r['body']}")
            return json.loads(r["body"])

        live = list(MAINS_WORKERS)

        # -- the http phase's set through the frontend ------------------------
        reqs = http_set["requests"]
        # warm-up: the set pinned to each worker, then routed, so that each
        # captures the decode graphs (width bucket, variant) the set reaches
        for pin in (*MAINS_WORKERS, None):
            await sse_client.main(port, [r if pin is None else dict(
                r, headers={"x-dynamo-worker": str(pin)}) for r in reqs])
            await clear()

        async def graphs():
            return sum(s["decode_graphs"] for s in (await all_stats(live)).values())

        runs, captured = [], []
        for _ in range(2):
            before = await graphs()
            runs.append(await sse_client.main(port, reqs))
            captured.append(await graphs() - before)
            await clear()
        for run in runs:
            for i, (r, (text, reason)) in enumerate(zip(run, http_set["texts"])):
                chunks, usage, done = sse_chunks(r)
                got = "".join(choice_text(c["choices"][0]) for _, c in chunks)
                finish = chunks[-1][1]["choices"][0]["finish_reason"] if chunks else None
                if r["status"] != 200 or not done or got != text or finish != reason:
                    fail(f"mains: request {i} through the frontend gave {r['status']} "
                         f"{got!r} ({finish}), the http phase {text!r} ({reason})")
        rows = http_set["rows"]
        latency = {"frontend": [http_latency_ms(run, rows) for run in runs],
                   "http_phase": [http_latency_ms(run, rows) for run in http_set["records"]],
                   "graphs_captured_in_frontend_runs": captured}
        step("parity")

        # -- the pin ---------------------------------------------------------
        tok = tiny_tokenizer()
        rng = np.random.default_rng(35)
        body = {"model": MAINS_MODEL, "prompt": pipeline_text(tok, rng, 200),
                "max_tokens": MAINS_MAX_TOKENS, "temperature": 0.0}

        async def served_on(coro):
            """(the response, the worker whose engine generated it)."""
            before = await all_stats(live)
            r = await coro
            after = await all_stats(live)
            moved = [w for w in live
                     if after[w]["generated_tokens"] != before[w]["generated_tokens"]]
            if r["status"] != 200 or len(moved) != 1:
                fail(f"mains: a request answered {r['status']} {r['body'][:300]} and moved "
                     f"the tokens of workers {moved}")
            return json.loads(r["body"]), moved[0], {w: after[w]["prefill_tokens"] -
                                                     before[w]["prefill_tokens"] for w in live}

        pinned = {}
        for wid in MAINS_WORKERS:
            doc, ran_on, _ = await served_on(post("/v1/completions", body, pin=wid))
            if ran_on != wid:
                fail(f"mains: pinned to {wid:#x}, the request ran on {ran_on:#x}")
            pinned[wid] = doc["choices"][0]["text"]
        if len(set(pinned.values())) != 1:
            fail(f"mains: the same request pinned to each worker gave {pinned}")
        # the prompt is cached on both now: drop it, cache it on the first
        # worker alone, then ask for the second by the JSON key only
        await clear()
        await served_on(post("/v1/completions", body, pin=MAINS_WORKERS[0]))
        await asyncio.sleep(5 * MAINS_INTERVAL_S)  # the KV events reach the router
        _, ran_on, _ = await served_on(post("/v1/completions", dict(
            body, _pinned_worker=MAINS_WORKERS[1])))
        if ran_on != MAINS_WORKERS[0]:
            fail(f"mains: a client's _pinned_worker key steered the request to {ran_on:#x}")
        step("pin")

        # -- KV routing through the mains -----------------------------------
        await clear()
        groups, hits = [], 0
        for g in range(MAINS_GROUPS):
            prefix = pipeline_text(tok, rng, MAINS_PREFIX_TOKENS)
            group = [dict(body, prompt=prefix + " " + pipeline_text(tok, rng, int(
                rng.integers(32, 201)))) for _ in range(MAINS_GROUP_SIZE)]
            _, leader, _ = await served_on(post("/v1/completions", group[0]))
            await asyncio.sleep(5 * MAINS_INTERVAL_S)  # events and a load report
            await until("idle workers", lambda: idle(live))
            before = await all_stats(live)
            docs = await asyncio.gather(*(post("/v1/completions", b) for b in group[1:]))
            after = await all_stats(live)
            prefilled = {w: after[w]["prefill_tokens"] - before[w]["prefill_tokens"] for w in live}
            prompts = sum(json.loads(d["body"])["usage"]["prompt_tokens"] for d in docs)
            on = [w for w in live if prefilled[w]]
            if on != [leader]:
                fail(f"mains: group {g}'s followers prefilled on {on}, its leader ran on "
                     f"{leader:#x}")
            hit = (prompts - prefilled[leader]) // KV_BLOCK
            if hit < (MAINS_GROUP_SIZE - 1) * (MAINS_PREFIX_TOKENS // KV_BLOCK):
                fail(f"mains: group {g}'s followers hit {hit} cached blocks, fewer than "
                     f"their shared prefix's")
            groups.append({"leader": hex(leader), "prefix_hit_blocks": hit})
            hits += hit
        step("kv_routing")

        # -- /clear_kv_blocks ----------------------------------------------
        await until("idle workers", lambda: idle(live))
        cached = sum(s["cached_blocks"] for s in (await all_stats(live)).values())
        doc = await clear()
        left = sum(s["cached_blocks"] for s in (await all_stats(live)).values())
        cleared = doc["results"].get(MAINS_MODEL, {}).get("cleared_blocks")
        if cleared != cached or left != 0 or cached <= 0:
            fail(f"mains: /clear_kv_blocks cleared {doc}, the workers held {cached} cached "
                 f"blocks before and {left} after")
        step("clear_kv")

        # -- the overload and trajectory planes -----------------------------
        overload = await overload_client(SimpleNamespace(
            procs=procs, everyone=everyone, port=port, http=http, get=get, post=post,
            stats=stats, clear=clear, listed=listed, body=body))
        step("overload")

        # -- the worker's system server -------------------------------------
        system = await system_client(SimpleNamespace(
            everyone=everyone, port=port, http=http, stats=stats, clear=clear, body=body, tok=tok,
            rng=rng, runtime=runtime, counts_file=counts_file, frontend=frontend),
            *await startup)
        step("system")

        # -- migration -------------------------------------------------------
        long_body = dict(body, prompt=pipeline_text(tok, rng, 150), max_tokens=MAINS_LONG_TOKENS,
                         stream=True, logprobs=2, stream_options={"include_usage": True})
        seen = {"tokens": 0, "times": []}

        def on_frame(t, frame):
            if frame.startswith("data: {"):
                chunk = json.loads(frame[6:])
                if chunk.get("choices"):
                    lp = chunk["choices"][0].get("logprobs") or {}
                    seen["tokens"] += len(lp.get("tokens") or [])
                    seen["times"].append(t)

        def long_text(record, what):
            """A complete long stream's tokens and their logprobs."""
            chunks = whole_stream(record, MAINS_LONG_TOKENS, f"mains: {what}",
                                  f"; the frontend's alarms: {frontend.alarms()}")
            lps = [c["choices"][0]["logprobs"] for _, c in chunks]
            return {"tokens": [t for lp in lps for t in lp["tokens"]],
                    "logprobs": [x for lp in lps for x in lp["token_logprobs"]]}

        graphs_before = {w: s["decode_graphs"] for w, s in (await all_stats(live)).items()}
        # pinned to the worker that is not SYSTEM_WORKER: that one survives,
        # and its SIGTERM below stores its perf fingerprints
        doomed = next(w for w in MAINS_WORKERS if w != SYSTEM_WORKER)
        stream = asyncio.ensure_future(http({"path": "/v1/completions", "body": long_body,
                                             "headers": {"x-dynamo-worker": str(doomed)}},
                                            on_frame))
        await until("the long stream's first tokens", lambda: seen["tokens"] > 0 or stream.done())
        serving = [w for w, s in (await all_stats(live)).items() if s["active_seqs"]]
        if serving != [doomed]:
            fail(f"mains: the long stream pinned to {doomed:#x} runs on workers {serving}")
        victim, survivor = serving[0], next(w for w in live if w != serving[0])
        await until(f"{MAINS_KILL_AFTER} tokens of the long stream",
                    lambda: seen["tokens"] >= MAINS_KILL_AFTER or stream.done())
        if stream.done():
            fail(f"mains: the long stream ended before the kill: {stream.result()}")
        workers[victim].proc.kill()
        t_kill = time.monotonic()
        everyone.remove((f"worker {victim:#x}", workers[victim]))
        tokens_at_kill = seen["tokens"]
        live = [survivor]
        record = await stream
        workers[victim].proc.wait(timeout=10)
        migrated = long_text(record, "the migrated stream")
        next_token_s = min(t for t in seen["times"] if t > t_kill) - t_kill
        survivor_captured = (await stats(survivor))["decode_graphs"] - graphs_before[survivor]
        dead = await until("liveness's dead line", lambda: frontend.find(
            rf"worker {victim:#x} declared DEAD after \S+ missed load reports \((\S+)s since",
            since=t_kill), timeout=10)
        detect_s = dead[0] - t_kill
        budget_s = MAINS_INTERVAL_S * MAINS_DEAD_AFTER + MAINS_INTERVAL_S
        if detect_s > budget_s:
            fail(f"mains: liveness declared {victim:#x} dead {detect_s:.3f} s after the kill, "
                 f"past {budget_s} s")
        metrics = (await get("/metrics"))["body"]
        migrations = sum(float(v) for v in re.findall(
            r'^dynamo_tpu_migration_migrations_total\{reason="[a-z_]+"\} (\S+)$', metrics,
            re.M))
        cards = await runtime.discovery.get_prefix("models/dynamo/")
        limit = min(doc["card"]["migration_limit"] for doc in cards.values())
        if not 1 <= migrations <= limit:
            fail(f"mains: /metrics counts {migrations} migrations (the card's limit {limit})")
        _, ran_on, _ = await served_on(post("/v1/completions", body))
        if ran_on != survivor:
            fail(f"mains: after the kill a request ran on {ran_on:#x}")
        # the request's witnesses on the survivor, each from an empty
        # cache: the request unbroken, then the request Migration built
        carried = sum(int(m.group(1)) for _, line in list(frontend.lines)
                      for m in [re.search(r"with (\d+) tokens carried", line)] if m)
        if not tokens_at_kill <= carried < MAINS_LONG_TOKENS:
            fail(f"mains: Migration carried {carried} tokens; the client had read "
                 f"{tokens_at_kill} at the kill")
        card = ModelDeploymentCard.from_dict(next(iter(cards.values()))["card"])
        card_tok = resolve_tokenizer(card)
        pre = OpenAIPreprocessor(card, card_tok, resolve_chat_template(card)).preprocess(
            dict(long_body))
        pre.request_id = "unbroken"
        await until("the survivor's generate instance", lambda: survivor in gen.instance_ids)

        async def on_survivor(req, want_tokens):
            """A request sent to the survivor's generate endpoint from an
            empty cache: its token ids, (decoded token, logprob) pairs and
            top alternatives."""
            await clear()
            ids, lps, tops, finish = [], [], [], None
            async for out in gen.direct(req.to_dict(), survivor, Context()):
                out = out if isinstance(out, dict) else out.to_dict()
                if out.get("error"):
                    fail(f"mains: {req.request_id} on the survivor failed: {out['error']}")
                ids += out["token_ids"]
                lps += [step[0]["logprob"] for step in out.get("logprobs") or []]
                tops += [{card_tok.decode([t["token_id"]]): t["logprob"] for t in step[1:]}
                         for step in out.get("logprobs") or []]
                finish = out.get("finish_reason") or finish
            if len(ids) != want_tokens or len(lps) != want_tokens or finish != "length":
                fail(f"mains: {req.request_id} on the survivor gave {len(ids)} tokens, "
                     f"{len(lps)} logprobs, finish {finish}; want {want_tokens}, length")
            return ids, list(zip((card_tok.decode([i]) for i in ids), lps)), tops

        unbroken_ids, unbroken, unbroken_top = await on_survivor(pre, MAINS_LONG_TOKENS)
        witness_req = _carry_tokens(pre, unbroken_ids[:carried])
        witness_req.request_id = "witness"
        _, witness, _ = await on_survivor(witness_req, MAINS_LONG_TOKENS - carried)
        got = list(zip(migrated["tokens"], migrated["logprobs"]))

        def first_apart(a, b):
            return next((k for k, (x, y) in enumerate(zip(a, b)) if x != y), None)

        head_apart = first_apart(got[:carried], unbroken[:carried])
        tail_apart = first_apart(got[carried:], witness)
        if head_apart is not None or tail_apart is not None:
            k = head_apart if head_apart is not None else carried + tail_apart
            fail(f"mains: the migrated stream (carried {carried}, killed at {tokens_at_kill}) "
                 f"parts at token {k}: {got[k:k + 4]} against "
                 f"{(unbroken if head_apart is not None else [None] * carried + witness)[k:k + 4]}"
                 f" ({'the unbroken run' if head_apart is not None else 'its witness'}); "
                 f"the frontend's alarms: {frontend.alarms()}")
        # printed only: where the unbroken run parts from the migrated
        # stream, the gap of its top two there, and the chosen tokens'
        # logprobs apart by span, before the kill and after it
        parted = first_apart([t for t, _ in got], [t for t, _ in unbroken])
        edges = [0, carried, carried + 16, carried + 64, carried + 256,
                 parted if parted is not None else MAINS_LONG_TOKENS]
        drift = {f"{a}-{b}": max(abs(x[1] - y[1]) for x, y in zip(got[a:b], unbroken[a:b]))
                 for a, b in zip(edges, edges[1:]) if a < b}
        margin = None
        if parted is not None:
            alt = unbroken_top[parted].get(got[parted][0])
            margin = None if alt is None else unbroken[parted][1] - alt
        step("migration")

        # -- shutdown --------------------------------------------------------
        workers[survivor].proc.send_signal(signal.SIGTERM)
        t_term = time.monotonic()
        try:
            rc = workers[survivor].proc.wait(timeout=MAINS_GRACE_S)
        except subprocess.TimeoutExpired:
            fail(f"mains: the survivor did not exit within {MAINS_GRACE_S} s of SIGTERM")
        term_s = time.monotonic() - t_term
        if rc != 0:
            fail(f"mains: the survivor exited {rc} on SIGTERM: {workers[survivor].tail()}")
        # the survivor (SYSTEM_WORKER) stored its perf ledger's fingerprints
        try:
            with open(fingerprints) as f:
                stored = json.load(f)
        except (OSError, ValueError) as exc:
            fail(f"mains: no fingerprint file after the survivor's SIGTERM: {exc!r}")
            stored = {"fingerprints": {}, "identity": {}}
        mine = {k: v for k, v in stored["fingerprints"].items()
                if k.startswith(f"{MAINS_MODEL}|") and k.split("|")[2] == DEV}
        if not mine or stored["identity"].get("backend") != DEV:
            fail(f"mains: the fingerprint file holds {sorted(stored['fingerprints'])} for "
                 f"{stored['identity']}; want a record of {MAINS_MODEL} on {DEV}")
        instances = await runtime.discovery.get_prefix(
            instance_prefix("dynamo", "backend", "generate"))
        if any(k.endswith(f"{survivor:016x}") for k in instances):
            fail(f"mains: the survivor's instance is still in discd: {sorted(instances)}")
        await until("an empty /v1/models", lambda: _is(listed(), []), timeout=MAINS_WAIT_S)
        t_gone = time.monotonic()
        r = await post("/v1/completions", body)
        if r["status"] < 400 or "error" not in json.loads(r["body"]):
            fail(f"mains: with no worker a request got {r['status']} {r['body'][:300]}")
        frontend.proc.send_signal(signal.SIGTERM)
        try:
            rc = frontend.proc.wait(timeout=MAINS_GRACE_S)
        except subprocess.TimeoutExpired:
            fail("mains: the frontend did not exit within its grace period of SIGTERM")
        if rc != 0:
            fail(f"mains: the frontend exited {rc} on SIGTERM: {frontend.tail()}")
        step("shutdown")
        return {
            "registration_s": t_listed - t_spawn, "listed_after_serving_s": t_listed - max(served),
            "latency": latency, "pinned_text_chars": len(pinned[MAINS_WORKERS[0]]),
            "long_stream_distinct_tokens": len(set(unbroken_ids)),
            "groups": groups, "prefix_hit_blocks": hits, "cleared_blocks": cleared,
            "migration": {"killed": hex(victim), "tokens_at_kill": tokens_at_kill,
                          "kill_to_next_token_s": next_token_s, "detection_s": detect_s,
                          "graphs_captured_on_survivor": survivor_captured,
                          "carried": carried, "equal_to_witness_after_carried": True,
                          "parted_from_unbroken_at": parted, "parting_margin": margin,
                          "logprob_drift_by_span": drift,
                          "liveness_since_last_s": float(dead[1].group(1)),
                          "migrations": migrations, "limit": limit},
            "sigterm_exit_s": term_s, "model_gone_after_kill_s": t_gone - t_kill,
            "fingerprints_at_sigterm": {k: {f: v[f] for f in ("step_p50_s", "toks_per_sec",
                                                             "samples")}
                                        for k, v in mine.items()},
            "steps_s": steps, "overload": overload, "system": system}
    finally:
        await ctl.close()
        await gen.close()
        await runtime.shutdown(grace_period=1)
        await runtime.event_plane.close()


def _tensors(tree):
    """The tensors of a params tree (nested dicts, lists and tuples)."""
    import torch

    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


async def system_startup(worker, everyone):
    """The system server's probes while its worker starts: /live answers as
    soon as ``system server on :PORT`` is printed; /readyz, polled from then
    on, answers 503 until it answers 200, and 200 once ``worker serving``
    is printed. Returns (port, the startup's figures)."""
    from dynamo_tpu_torch.tools import sse_client

    t_line, m = await until("the system server's line", lambda: worker.find(
        r"system server on :(\d+)"), timeout=300, procs=everyone)
    port = int(m.group(1))
    live = await sse_client.one(port, {"method": "GET", "path": "/live"})
    t_live = time.monotonic()
    if live["status"] != 200 or json.loads(live["body"]) != {"status": "live"}:
        fail(f"system: /live right after the server's line answered {live['status']} "
             f"{live.get('body')}")
    polls, t0 = [], time.monotonic()
    while True:
        r = await sse_client.one(port, {"method": "GET", "path": "/readyz"})
        polls.append(r["status"])
        if r["status"] == 200:
            t_ready = time.monotonic()
            break
        if r["status"] != 503 or json.loads(r["body"])["status"] != "not_ready":
            fail(f"system: /readyz before ready answered {r['status']} {r.get('body')}")
        if time.monotonic() - t0 > 300:
            fail(f"system: /readyz not 200 within 300 s: {worker.tail()}")
        await asyncio.sleep(0.005)
    t_serving, _ = await until("the worker's serving line", lambda: worker.find(
        r"worker serving "), timeout=MAINS_WAIT_S, procs=everyone)
    r = await sse_client.one(port, {"method": "GET", "path": "/readyz"})
    if r["status"] != 200 or json.loads(r["body"])["status"] != "ready":
        fail(f"system: /readyz after `worker serving` answered {r['status']} {r.get('body')}")
    return port, {"live_after_line_ms": 1e3 * (t_live - t_line), "readyz_polls": len(polls),
                  "readyz_503_polls": polls.count(503), "saw_503": 503 in polls,
                  "line_to_ready_ms": 1e3 * (t_ready - t_line),
                  "ready_to_serving_line_ms": 1e3 * (t_serving - t_ready)}


async def system_client(m, port, startup) -> dict:
    """The system server of worker SYSTEM_WORKER inside the mains
    deployment, after the overload part warmed its decode buckets: its
    /metrics, /debug/memory against the CUDA allocator (read in the worker
    through its counts file), a /debug/profile capture while the frontend
    streams, /engine/clear_kv_blocks and its KV event, the debug routes for
    a traced request, the 501 refusals, ``cli observe kvcache``, and what
    a scrape costs. Returns the system line's figures."""
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.models.config import qwen2_500m_config
    from dynamo_tpu_torch.router.protocols import kv_events_topic
    from dynamo_tpu_torch.runtime.device_observe import TRACE_FILE
    from dynamo_tpu_torch.tools import sse_client
    from dynamo_tpu_torch.worker.__main__ import build_parser

    import torch

    wid, out = SYSTEM_WORKER, {"startup": startup}

    async def sget(path):
        return await sse_client.one(port, {"method": "GET", "path": path})

    async def spost(path, body):
        return await sse_client.one(port, {"path": path, "body": body})

    async def idle():
        s = await m.stats(wid)
        return not (s["active_seqs"] or s["waiting"] or s["inflight_bursts"])

    async def settled_alloc():
        """The worker's allocator bytes, read twice 0.6 s apart while idle
        (the counts file is written every 0.25 s): equal, or None."""
        await until(f"worker {wid:#x} idle", idle, procs=m.everyone)
        with open(counts_file_alloc) as f:
            first = json.load(f)
        await asyncio.sleep(0.6)
        with open(counts_file_alloc) as f:
            again = json.load(f)
        return first if first == again else None

    counts_file_alloc = m.counts_file + ".alloc"
    kv_sub = m.runtime.event_plane.subscribe(kv_events_topic("dynamo", "backend"))

    # -- /metrics and /debug/memory, idle ---------------------------------
    cfg = qwen2_500m_config()
    args = build_parser().parse_args(["--model", MAINS_MODEL])
    kv_bytes = (2 * cfg.n_layers * (args.num_kv_blocks + 1) * args.block_size * cfg.n_kv_heads
                * cfg.head_dim_ * cfg.dtype.itemsize)
    # the worker's params are these shapes (random init, another seed's draws)
    params = {id(t): t for t in _tensors(llama.init_params(cfg, 0, DEV))}
    param_bytes = sum(t.nbytes for t in params.values())
    del params
    gc.collect()
    if DEV == "cuda":
        torch.cuda.empty_cache()
    for _ in range(5):
        alloc = await settled_alloc()
        metrics = (await sget("/metrics"))["body"]
        mem_r = await sget("/debug/memory")
        stats = await m.stats(wid)
        if alloc is not None and alloc == await settled_alloc():
            break
    else:
        fail("system: the worker's allocator bytes did not settle while idle")

    def gauge(series):
        found = re.search(rf"^{re.escape(series)} (\S+)$", metrics, re.M)
        if found is None:
            fail(f"system: /metrics has no {series}")
        return found and float(found.group(1))

    for key in ("decode_graphs", "generated_tokens"):
        if gauge(f"dynamo_tpu_engine_{key}") != stats[key]:
            fail(f"system: /metrics dynamo_tpu_engine_{key} {gauge(f'dynamo_tpu_engine_{key}')} "
                 f"!= /engine/stats {stats[key]}")
    for family in ("# TYPE dynamo_tpu_overload_state gauge", "# TYPE dynamo_tpu_slo_goodput_ratio",
                   "# TYPE dynamo_tpu_kvcache_hit_rate",
                   "# TYPE dynamo_tpu_liveness_stale_incarnation_drops_total",
                   "# TYPE dynamo_tpu_runtime_profiler_captures_total"):
        if family not in metrics:
            fail(f"system: /metrics lacks {family!r}")
    ledger_metrics = {c: gauge(f'dynamo_tpu_runtime_hbm_bytes{{category="{c}"}}')
                      for c in HBM_CATEGORIES}
    device_in_use = gauge('dynamo_tpu_runtime_hbm_device_bytes{device="0",kind="bytes_in_use"}')
    if device_in_use != alloc:
        fail(f"system: /metrics reads {device_in_use} device bytes in use, the worker's "
             f"allocator {alloc}")
    mem = json.loads(mem_r["body"])
    eng, detail = mem["sources"]["engine"], mem["sources"]["kv_pool_detail"]
    if {c: float(v) for c, v in eng.items()} != ledger_metrics:
        fail(f"system: /debug/memory {eng} != /metrics {ledger_metrics}")
    parts = detail["active_bytes"] + detail["cached_bytes"] + detail["free_bytes"] + \
        detail["sink_bytes"]
    if eng["kv_cache"] != kv_bytes or eng["params"] != param_bytes or \
            not parts == detail["total_bytes"] == eng["kv_cache"] or \
            mem.get("device_bytes_in_use") != alloc or mem.get("unaccounted_bytes", -1) < 0:
        fail(f"system: /debug/memory {mem}; want kv_cache {kv_bytes}, params {param_bytes}, "
             f"the detail summing to kv_cache, device bytes {alloc} and unaccounted >= 0")
    out["memory"] = {"ledger": eng, "kv_pool_detail": detail,
                     "ledger_total_bytes": mem["ledger_total_bytes"],
                     "device_bytes_in_use": mem.get("device_bytes_in_use"),
                     "unaccounted_bytes": mem.get("unaccounted_bytes"),
                     "devices": mem["devices"]}
    print(f"system: unaccounted_bytes {mem.get('unaccounted_bytes')} (the graph pool, "
          f"workspaces and the allocator's share) of {mem.get('device_bytes_in_use')} in use",
          flush=True)

    # -- a bounded profile while the frontend streams ------------------------
    # The process's first capture sets CUPTI up (seconds, off the worker's
    # event loop): an idle one first, as the decode buckets are warmed first.
    t0 = time.monotonic()
    for action in ("start", "stop"):
        r = await spost("/debug/profile", {"action": action})
        if r["status"] != 200 or not json.loads(r["body"]).get("ok"):
            fail(f"system: the idle capture's {action} answered {r['status']} {r['body']}")
    first_capture_s = time.monotonic() - t0
    graphs0 = (await m.stats(wid))["decode_graphs"]
    dead = rf"worker {wid:#x} declared DEAD"
    dead_before = sum(1 for _, line in list(m.frontend.lines) if re.search(dead, line))
    pin = {"x-dynamo-worker": str(wid)}
    fill = dict(m.body, max_tokens=OVERLOAD_FILL_TOKENS, nvext={"ignore_eos": True}, stream=True)
    fillers = [await HeldStream.open(m.port, fill, pin) for _ in range(SYSTEM_PROFILE_LOAD)]

    async def loaded():
        s = await m.stats(wid)
        return s if s["active_seqs"] >= SYSTEM_PROFILE_LOAD and min(
            f.frames for f in fillers) > 1 else None

    await until(f"worker {wid:#x} decoding {SYSTEM_PROFILE_LOAD} streams", loaded,
                procs=m.everyone)
    live_ms, frames_at = [], []  # /live's answer times; (time, the fillers' frames)

    async def poll_live():
        while True:
            t0 = time.perf_counter()
            await sget("/live")
            live_ms.append(1e3 * (time.perf_counter() - t0))
            frames_at.append((time.monotonic(), sum(f.frames for f in fillers)))
            await asyncio.sleep(SYSTEM_LIVE_POLL_S)

    poller = asyncio.ensure_future(poll_live())
    r = await spost("/debug/profile", {"action": "start", "seconds": SYSTEM_PROFILE_S})
    started = json.loads(r["body"])
    if r["status"] != 200 or not started.get("ok") or "CUDA" not in started.get("activities", ()):
        fail(f"system: /debug/profile start answered {r['status']} {started}")
    t_start = time.monotonic()
    load_at_start = (await m.stats(wid))["active_seqs"]
    long_prompt = dict(m.body, prompt=pipeline_text(m.tok, m.rng, SYSTEM_PROFILE_PROMPT),
                       max_tokens=SYSTEM_PROFILE_TOKENS)
    inside = await m.http({"path": "/v1/completions", "headers": pin, "body": long_prompt})
    if inside["status"] != 200:
        fail(f"system: the request inside the profile answered {inside['status']}")

    async def stopped():
        got = json.loads((await spost("/debug/profile", {"action": "status"}))["body"])
        return got if not got["active"] else None

    status = await until("the capture's auto-stop", stopped, timeout=SYSTEM_PROFILE_S + 180,
                         procs=m.everyone)
    stopped_after_s = time.monotonic() - t_start
    # The fillers paused while the stop parked the engine: they go on to
    # their [DONE].
    await until("the profiled fillers' ends", lambda: all(f.done for f in fillers),
                procs=m.everyone)
    poller.cancel()
    for f in fillers:
        f.close()
    graphs1 = (await m.stats(wid))["decode_graphs"]
    if graphs1 != graphs0:
        fail(f"system: {graphs1 - graphs0} decode graphs were captured inside the profile: "
             "its buckets were not warm")
    with open(os.path.join(started["dir"], TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    ours = sorted({k.group(0) for e in kernels
                   for k in [re.search(r"paged_attention_\w+", e["name"])] if k})
    if not ours:
        fail(f"system: the trace names no paged_attention kernel among {len(kernels)} kernels")
    await asyncio.sleep(5 * MAINS_INTERVAL_S)  # a liveness verdict would be in by now
    t_auto = t_start + SYSTEM_PROFILE_S
    in_stop = [n for t, n in frames_at if t_auto <= t <= t_start + stopped_after_s]
    longest_pause, t_moved, last = 0.0, None, None
    for t, n in frames_at:  # the stop parks the engine: the fillers pause
        if n != last:
            t_moved, last = t, n
        if t <= t_start + stopped_after_s:
            longest_pause = max(longest_pause, t - t_moved)
    out["profile"] = {
        "seconds": SYSTEM_PROFILE_S, "captures": status["captures"],
        "first_capture_s": first_capture_s, "streams_at_start": load_at_start,
        "stopped_after_s": stopped_after_s, "live_polls": len(live_ms),
        "live_max_ms": max(live_ms), "live_limit_ms": 1e3 * MAINS_INTERVAL_S,
        "filler_frames_during_stop": in_stop[-1] - in_stop[0] if in_stop else None,
        "filler_longest_pause_s": longest_pause,
        "trace_events": len(events), "kernel_events": len(kernels), "port_kernels_named": ours,
        # the worker decodes only by replaying a burst's graph
        "graph_replayed_kernels_in_trace": bool(set(ours) - {"paged_attention_chunk_kernel"}),
        "declared_dead_meanwhile": sum(1 for _, line in list(m.frontend.lines)
                                       if re.search(dead, line)) - dead_before,
        "trace_mb": os.path.getsize(os.path.join(started["dir"], TRACE_FILE)) / 2**20}
    del events, kernels
    if out["profile"]["declared_dead_meanwhile"] or max(live_ms) > 1e3 * MAINS_INTERVAL_S:
        fail(f"system: profiling the loaded worker stalled it: {out['profile']}")

    # -- /engine/clear_kv_blocks and its KV event ----------------------------
    await until(f"worker {wid:#x} idle", idle, procs=m.everyone)
    cached = (await m.stats(wid))["cached_blocks"]
    r = await spost("/engine/clear_kv_blocks", {})
    if r["status"] != 200 or json.loads(r["body"]) != {"cleared_blocks": cached} or cached <= 0:
        fail(f"system: /engine/clear_kv_blocks answered {r['status']} {r['body']}; the worker "
             f"held {cached} cached blocks")

    async def cleared_event():
        while True:
            _, ev = await kv_sub.get(MAINS_WAIT_S)
            if ev.get("kind") == "cleared" and ev.get("worker_id") == wid:
                return ev

    await asyncio.wait_for(cleared_event(), MAINS_WAIT_S)
    await kv_sub.aclose()
    out["cleared_blocks"] = cached

    # -- the debug routes for a traced request through the frontend ----------
    trace_id = SYSTEM_TRACEPARENT.split("-")[1]
    chat = {"model": MAINS_MODEL, "messages": [{"role": "user", "content": "system server"}],
            "max_tokens": 16, "temperature": 0.0}
    r = await m.http({"path": "/v1/chat/completions", "body": chat,
                      "headers": {**pin, "traceparent": SYSTEM_TRACEPARENT}})
    if r["status"] != 200:
        fail(f"system: the traced chat answered {r['status']}")

    async def traced():
        spans = json.loads((await sget(f"/debug/traces?trace_id={trace_id}"))["body"])["spans"]
        return spans if {"endpoint.serve", "engine.decode"} <= {s["name"] for s in spans} \
            else None

    spans = await until("the traced request's spans on the worker", traced, procs=m.everyone)
    requests = json.loads((await sget("/debug/requests"))["body"])
    mine = [q for q in requests["requests"] if q["trace_id"] == trace_id]
    view = await sget(f"/debug/trajectory/{trace_id}")
    kv = json.loads((await sget("/debug/kvcache"))["body"])
    index = json.loads((await sget("/debug/trajectory"))["body"])
    if not mine or "prefill_start" not in mine[0]["events"] or view["status"] != 200 or \
            not any(t["trace_id"] == trace_id for t in index["traces"]) or "hits" not in kv:
        fail(f"system: the debug routes for trace {trace_id}: requests {mine}, trajectory "
             f"{view['status']}, index {index['traces'][:3]}, kvcache {sorted(kv)}")
    one = await sget(f"/debug/requests/{mine[0]['request_id']}")
    if one["status"] != 200:
        fail(f"system: /debug/requests/{mine[0]['request_id']} answered {one['status']}")
    out["debug"] = {"spans": sorted({s["name"] for s in spans}), "request": mine[0],
                    "trajectory_phases": json.loads(view["body"])["phases"]}

    # -- the refusals -------------------------------------------------------
    refusals = {}
    for method, path, item in (("GET", "/drain", "A11"), ("POST", "/drain", "A11"),
                               ("GET", "/v1/loras", "A7"), ("DELETE", "/v1/loras/x", "A7")):
        r = await sse_client.one(port, {"method": method, "path": path,
                                        **({"body": {}} if method == "POST" else {})})
        if r["status"] != 501 or f"(ROADMAP {item})" not in json.loads(r["body"])["error"]:
            fail(f"system: {method} {path} answered {r['status']} {r.get('body')}")
        refusals[f"{method} {path}"] = r["status"]
    out["refusals"] = refusals

    # -- cli observe kvcache, perf and the device plane ----------------------
    for view, head in (("kvcache", "== kv reuse"), ("perf", "== perf ledger"),
                       (None, "== compiled programs")):
        cli = await asyncio.to_thread(subprocess.run, [
            sys.executable, "-m", "dynamo_tpu_torch.cli", "observe", *([view] if view else []),
            "--port", str(port)], capture_output=True, text=True, timeout=60,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        if cli.returncode != 0 or head not in cli.stdout:
            fail(f"system: cli observe {view or ''} exited {cli.returncode}: "
                 f"{cli.stdout[-500:]} {cli.stderr[-1500:]}")
        out[f"cli_observe_{view or 'device'}_lines"] = len(cli.stdout.splitlines())

    # -- what a scrape costs while the worker serves, and the perf plane -----
    streams = [dict(m.body, max_tokens=256, stream=True, nvext={"ignore_eos": True},
                    stream_options={"include_usage": True}) for _ in range(SYSTEM_ITL_STREAMS)]
    scraped = {}  # the last body of each route a scraper read while streams ran

    async def captures():
        compiles = json.loads((await sget("/debug/compiles"))["body"])
        return compiles["totals"]["compiles"], (await m.stats(wid))["decode_graphs"]

    async def run_streams(scrape_every):
        """The streams at once, pinned to the worker; with ``scrape_every``
        a scraper GETs /metrics, /debug/memory, /debug/perf and
        /debug/compiles that often meanwhile. Returns the mean ITL, the
        scrapes a route, and the captures the run held."""
        await m.clear()
        done = asyncio.Event()
        scrapes = {path: [] for path in SYSTEM_SCRAPED}
        before = await captures()

        async def scraper():
            while not done.is_set():
                for path, times in scrapes.items():
                    t0 = time.perf_counter()
                    r = await sget(path)
                    times.append(1e6 * (time.perf_counter() - t0))
                    if r["status"] != 200:
                        fail(f"system: a scrape of {path} answered {r['status']}")
                    scraped[path] = r["body"]
                try:
                    await asyncio.wait_for(done.wait(), scrape_every)
                except asyncio.TimeoutError:
                    pass

        task = asyncio.ensure_future(scraper()) if scrape_every else None
        records = await asyncio.gather(*(m.http({"path": "/v1/completions", "headers": pin,
                                                 "body": b}) for b in streams))
        done.set()
        if task is not None:
            await task
        for i, rec in enumerate(records):
            whole_stream(rec, 256, f"system: stream {i} of the ITL comparison")
        after = await captures()
        return (http_latency_ms(records, range(len(records)))[2], len(scrapes["/metrics"]),
                [a - b for a, b in zip(after, before)])

    itl = {"without": [], "with": [], "scrapes_a_run": [], "captures_inside": []}
    for scrape_every in (None, SYSTEM_SCRAPE_S, SYSTEM_SCRAPE_S, None):
        mean_itl, n, captured = await run_streams(scrape_every)
        itl["with" if scrape_every else "without"].append(mean_itl)
        itl["captures_inside"].append(captured)
        if scrape_every:
            itl["scrapes_a_run"].append(n)
    print(f"system: captures inside the measured streams (compiles, graphs) a run: "
          f"{itl['captures_inside']}", flush=True)
    # idle: /metrics and /debug/compiles read between two equal stats
    await until(f"worker {wid:#x} idle", idle, procs=m.everyone)
    for _ in range(50):
        first = await m.stats(wid)
        metrics = (await sget("/metrics"))["body"]
        compiles = json.loads((await sget("/debug/compiles"))["body"])
        last = await m.stats(wid)
        if all(first[k] == last[k] for k in ("decode_steps", "decode_graphs")):
            break
        await asyncio.sleep(0.1)
    out["perf"] = perf_plane_checks(scraped, last, metrics, compiles)
    # the µs a scrape takes while a stream runs, each route SYSTEM_SCRAPES times
    await m.clear()
    busy = asyncio.ensure_future(m.http({"path": "/v1/completions", "headers": pin,
                                         "body": dict(streams[0], max_tokens=1024)}))

    async def serving():
        return (await m.stats(wid))["active_seqs"] > 0 or busy.done()

    await until("the scraped stream's start", serving, procs=m.everyone)
    scrape_us = {}
    for path in SYSTEM_SCRAPED:
        times = []
        for _ in range(SYSTEM_SCRAPES):
            t0 = time.perf_counter()
            await sget(path)
            times.append(1e6 * (time.perf_counter() - t0))
        times.sort()
        scrape_us[path] = {"p50": times[len(times) // 2], "p90": times[int(0.9 * (len(times) - 1))],
                           "max": times[-1], "busy": not busy.done()}
    whole_stream(await busy, 1024, "system: the scraped stream")
    out["scrape_us"] = scrape_us
    out["itl_ms"] = {**itl, "scrape_interval_s": SYSTEM_SCRAPE_S, "streams": SYSTEM_ITL_STREAMS,
                     "tokens": 256}
    await m.clear()
    return out


def perf_plane_checks(scraped, stats, metrics, compiles) -> dict:
    """The system worker's perf plane: the /debug/perf body a scraper read
    while the ITL comparison's streams ran (decode rows with live samples,
    each roofline fraction in (0, 1.05] and equal, within 1e-6, to its
    tok/s over the card's roofline recomputed from the row's median
    occupancy and context), then, idle, /metrics' decode step count equal
    to the engine's reaped bursts and /debug/compiles' captures equal to
    its graphs. Returns the system line's perf figures."""
    from dynamo_tpu_torch.models.config import qwen2_500m_config
    from dynamo_tpu_torch.runtime.roofline import make_roofline_fn

    roofline = make_roofline_fn(qwen2_500m_config(), None)
    perf = json.loads(scraped.get("/debug/perf") or "{}")
    rows = [r for r in perf.get("decode", ()) if r["samples"] > 0]
    if not rows:
        fail(f"system: /debug/perf held no decode row with samples while streams ran: {perf}")
    for r in rows:
        frac = r.get("roofline_fraction")
        want = r["toks_per_sec"] / roofline(int(round(r["occupancy_p50"])), r["avg_ctx_p50"])
        if frac is None or not 0 < frac <= 1.05 or abs(frac - want) > 1e-6:
            fail(f"system: /debug/perf row {r}: roofline_fraction {frac}, the card's roofline "
                 f"gives {want}")
    found = re.search(r'^dynamo_tpu_engine_step_duration_seconds_count\{phase="decode"\} (\S+)$',
                      metrics, re.M)
    decode_count = found and int(float(found.group(1)))
    if decode_count != stats["decode_steps"]:
        fail(f"system: /metrics counts {decode_count} decode steps, /engine/stats "
             f"{stats['decode_steps']} reaped bursts")
    if compiles["totals"]["compiles"] != stats["decode_graphs"]:
        fail(f"system: /debug/compiles counts {compiles['totals']} captures, the runner holds "
             f"{stats['decode_graphs']} graphs")
    for family in ("# TYPE dynamo_tpu_perf_roofline_fraction gauge",
                   "# TYPE dynamo_tpu_perf_step_p50_seconds gauge",
                   "# TYPE dynamo_tpu_engine_host_gap_seconds histogram",
                   "# TYPE dynamo_tpu_runtime_compiles_total counter"):
        if family not in metrics:
            fail(f"system: /metrics lacks {family!r}")
    return {"decode_rows": [{k: r.get(k) for k in (
                "width", "variant", "path", "samples", "step_p50_s", "toks_per_sec",
                "occupancy_p50", "avg_ctx_p50", "roofline_fraction")} for r in rows],
            "roofline_fraction": [min(r["roofline_fraction"] for r in rows),
                                  max(r["roofline_fraction"] for r in rows)],
            "decode_steps": decode_count, "compiles": compiles["totals"],
            "verdicts": {k: v["verdict"] for k, v in perf.get("verdicts", {}).items()},
            "prefill": perf.get("prefill")}


async def _is(coro, want):
    return await coro == want


def whole_stream(record, tokens, what, more=""):
    """A streamed completion that ended whole: status 200, no error frame,
    finish_reason length, ``tokens`` tokens, [DONE]; its (time, chunk)s."""
    chunks, usage, done = sse_chunks(record)
    errors = [f for _, f in record["frames"] if f.startswith("data: {") and
              "error" in json.loads(f[6:])]
    finish = chunks[-1][1]["choices"][0]["finish_reason"] if chunks else None
    if record["status"] != 200 or errors or not done or finish != "length" or \
            (usage or {}).get("completion_tokens") != tokens:
        fail(f"{what} ended {record['status']} {finish} {usage} [DONE] {done}, "
             f"errors {errors}{more}")
    return chunks


def stream_text(chunks):
    return "".join(choice_text(c["choices"][0]) for _, c in chunks)


async def overload_client(m) -> dict:
    """The overload and trajectory planes inside the mains deployment (the
    mains phase's client, before the kill): a traced request stitched
    across the frontend and a worker, a deadline shed behind a full engine,
    the caps frontend's typed 429s, and the SLA frontend's brownout, clamp
    and 503. Returns the overload line's figures."""
    import signal

    from dynamo_tpu_torch.tools import sse_client

    out = {}
    wid = MAINS_WORKERS[0]

    # -- one trace id, stitched across the frontend and a worker -----------
    chat = {"model": MAINS_MODEL, "messages": [{"role": "user", "content": "paged attention"}],
            "max_tokens": 32, "temperature": 0.0, "stream": True}
    trace_id = TRACEPARENT.split("-")[1]
    r = await m.http({"path": "/v1/chat/completions", "body": chat,
                      "headers": {"traceparent": TRACEPARENT}})
    if r["status"] != 200 or not sse_chunks(r)[2]:
        fail(f"overload: the traced chat answered {r['status']} {r['frames'][-3:]}")
    need = {"http.chat_completions", "overload.queue", "router.select_worker",
            "endpoint.serve", "engine.queue", "engine.prefill", "engine.decode"}

    async def stitched():
        got = await m.get(f"/debug/trajectory/{trace_id}")
        if got["status"] != 200:
            return None
        view = json.loads(got["body"])
        return view if need <= {s["name"] for s in view["spans"]} else None

    t_done = time.monotonic()
    view = await until("the traced request's worker spans on /debug/trajectory", stitched,
                       procs=m.everyone)
    phases = view["phases"]
    if not (phases["queue"] > 0 and phases["prefill"] > 0 and phases["decode"] > 0) or \
            abs(sum(phases.values()) - view["root_ms"]) > 0.01 or view["skew_flagged"] or \
            not view["complete"] or not any(p.startswith("worker-") for p in view["processes"]):
        fail(f"overload: the stitched trajectory {json.dumps(view)[:3000]}")
    out["trajectory"] = {"processes": view["processes"], "spans": len(view["spans"]),
                         "root_ms": view["root_ms"], "phases": phases,
                         "dominant_phase": view["dominant_phase"],
                         "kv_reuse": view["kv_reuse"], "skew_flagged": view["skew_flagged"],
                         "stitched_after_s": time.monotonic() - t_done}

    # -- a deadline shed behind a full engine (the default frontend) ----------
    fill = dict(m.body, max_tokens=OVERLOAD_FILL_TOKENS, nvext={"ignore_eos": True},
                stream=True)

    async def idle():
        s = await m.stats(wid)
        return s["active_seqs"] + s["waiting"] == 0

    async def fill_engine():
        fillers = [await HeldStream.open(m.port, fill, {"x-dynamo-worker": str(wid)})
                   for _ in range(16)]
        return fillers, await until(f"worker {wid:#x}'s 16 slots busy",
                                    lambda: _full(m, wid), procs=m.everyone)

    if not await idle():
        fail(f"overload: worker {wid:#x} is not idle: {await m.stats(wid)}")
    # A first pass, longer than the measured one, captures the fillers'
    # decode graphs (ROADMAP C note 5), so that no capture delays the shed.
    fillers, _ = await fill_engine()
    await asyncio.sleep(OVERLOAD_DEADLINE_MS / 1000 + OVERLOAD_WARM_S)
    for f in fillers:
        f.close()
    await until(f"worker {wid:#x} idle after the first pass", idle, procs=m.everyone)
    await m.clear()
    fillers, full = await fill_engine()
    sheds_before = full["deadline_sheds"]
    t_sent = time.monotonic()
    # the engine sheds it at its deadline, with every slot still busy
    late = await asyncio.wait_for(m.http({
        "path": "/v1/completions", "body": m.body, "headers": {
            "x-dynamo-worker": str(wid), "x-dynamo-deadline-ms": str(OVERLOAD_DEADLINE_MS)}}),
        MAINS_WAIT_S)
    answered_s = time.monotonic() - t_sent
    after = await m.stats(wid)
    frames, ended = [f.frames for f in fillers], [f.task.done() for f in fillers]
    for f in fillers:
        f.close()
    doc = json.loads(late["body"])
    if late["status"] != 504 or doc.get("error", {}).get("error_kind") != "timeout" or \
            "deadline expired before admission" not in doc["error"].get("message", ""):
        fail(f"overload: the pinned request past its deadline answered {late['status']} "
             f"{late['body'][:500]}")
    if after["active_seqs"] < 16 or any(ended) or min(frames) < 1:
        fail(f"overload: the fillers did not all run through the shed: {after['active_seqs']} "
             f"active, ended {ended}, frames {frames}")
    sheds = after["deadline_sheds"] - sheds_before
    if sheds < 1:
        fail(f"overload: worker {wid:#x} counts {sheds} deadline sheds")
    out["deadline_shed"] = {"worker": hex(wid), "deadline_ms": OVERLOAD_DEADLINE_MS,
                            "answered_after_s": answered_s, "deadline_sheds": sheds,
                            "graphs_captured_meanwhile":
                                after["decode_graphs"] - full["decode_graphs"],
                            "capture_ms_meanwhile":
                                after["graph_capture_ms"] - full["graph_capture_ms"]}
    await m.clear()

    # -- the caps frontend: 4 run, 4 queue, the rest shed 429 ---------------
    ports = {}
    for name in ("frontend caps", "frontend sla"):
        ports[name] = int((await until(f"the {name}'s listening line", lambda n=name: m.procs[
            n].find(r"frontend listening on \S+:(\d+)"), procs=m.everyone))[1].group(1))

        async def models(p=ports[name]):
            got = await sse_client.one(p, {"method": "GET", "path": "/v1/models"})
            return [x["id"] for x in json.loads(got["body"])["data"]]

        await until(f"the model on the {name}'s /v1/models", lambda f=models: _is(
            f(), [MAINS_MODEL]), procs=m.everyone)
    burst_body = dict(m.body, max_tokens=OVERLOAD_TOKENS, stream=True, nvext={
        "ignore_eos": True}, stream_options={"include_usage": True})
    want = stream_text(whole_stream(await m.http({"path": "/v1/completions",
                                                  "body": burst_body}),
                                    OVERLOAD_TOKENS, "overload: the burst request alone"))
    await m.clear()
    caps = ports["frontend caps"]
    records = await asyncio.wait_for(sse_client.main(caps, [
        {"path": "/v1/completions", "body": burst_body}] * OVERLOAD_BURST), MAINS_WAIT_S * 4)
    admitted = [r for r in records if r["status"] == 200]
    shed = [r for r in records if r["status"] != 200]
    for i, r in enumerate(admitted):
        if stream_text(whole_stream(r, OVERLOAD_TOKENS, f"overload: admitted stream {i}")) \
                != want:
            fail(f"overload: admitted stream {i} parts from the request run alone")
    for r in shed:
        doc = json.loads(r["body"])
        if r["status"] != 429 or r["headers"].get("retry-after") != "1" or \
                doc["error"].get("error_kind") != "queue_full" or \
                doc["error"].get("type") != "overloaded":
            fail(f"overload: a shed answered {r['status']} {r['headers']} {r['body'][:300]}")
    if len(admitted) != 8 or len(shed) != OVERLOAD_BURST - 8:
        fail(f"overload: the caps frontend admitted {len(admitted)} of {OVERLOAD_BURST}")
    if max(r["t_end"] for r in shed) >= min(r["t_end"] for r in admitted):
        fail("overload: an admitted stream ended before the last shed was answered")
    snap = json.loads((await sse_client.one(caps, {"method": "GET",
                                                   "path": "/debug/overload"}))["body"])
    if snap["admitted"] != 8 or snap["sheds"] != {"queue_full": OVERLOAD_BURST - 8} or \
            snap["peak_queue_depth"] != 4 or snap["state"] != "healthy":
        fail(f"overload: the caps frontend's /debug/overload {snap}")
    out["caps"] = {"admitted": len(admitted), "shed_429": len(shed),
                   "retry_after": shed[0]["headers"]["retry-after"],
                   "latency_ms": http_latency_ms(admitted, range(len(admitted)))}
    await m.clear()

    # -- the SLA frontend: healthy -> brownout (the clamp) -> shed (503) -----
    sla = ports["frontend sla"]

    async def state():
        got = await sse_client.one(sla, {"method": "GET", "path": "/debug/overload"})
        return json.loads(got["body"])

    long_body = dict(burst_body, max_tokens=1500)
    frames = []
    long_stream = asyncio.ensure_future(sse_client.one(
        sla, {"path": "/v1/completions", "body": long_body}, lambda t, f: frames.append(t)))
    await until("the SLA frontend's ITL samples", lambda: len(frames) > 20 or long_stream.done(),
                procs=m.everyone)
    probe = dict(m.body, max_tokens=4)
    probes, clamped, shed_503 = [], None, None
    for _ in range(40):
        await asyncio.sleep(0.3)  # past min_eval_interval_s: each admission evaluates
        snap = await state()
        if snap["state"] == "brownout" and clamped is None:
            clamped = asyncio.ensure_future(sse_client.one(sla, {
                "path": "/v1/completions", "body": dict(
                    m.body, max_tokens=OVERLOAD_CLAMPED, nvext={"ignore_eos": True})}))
            continue
        r = await sse_client.one(sla, {"path": "/v1/completions", "body": probe})
        probes.append((snap["state"], r["status"]))
        if r["status"] == 503:
            shed_503 = r
            break
    if shed_503 is None or clamped is None:
        fail(f"overload: the SLA frontend went {probes}, clamp sent {clamped is not None}: "
             f"{await state()}")
    doc = json.loads(shed_503["body"])
    if doc["error"].get("error_kind") != "brownout_shed" or \
            shed_503["headers"].get("retry-after") != "1":
        fail(f"overload: the 503 {shed_503['headers']} {shed_503['body'][:300]}")
    snap = await state()
    metrics = (await sse_client.one(sla, {"method": "GET", "path": "/metrics"}))["body"]
    clamp_doc = await clamped
    long_rec = await long_stream
    whole_stream(long_rec, 1500, "overload: the SLA frontend's long stream")
    clamp = json.loads(clamp_doc["body"])
    if clamp_doc["status"] != 200 or clamp["usage"]["completion_tokens"] != 256 or \
            clamp["choices"][0]["finish_reason"] != "length":
        fail(f"overload: the clamped request {clamp_doc['status']} {clamp_doc['body'][:400]}")
    if not shed_503["t_end"] < long_rec["t_end"]:
        fail("overload: the 503 came after the admitted stream ended")
    states = [(e["frm"], e["to"]) for e in snap["events"] if e["kind"] == "state"]
    if snap["state"] != "shed" or snap["transitions"] != {"brownout": 1, "shed": 1} or \
            states != [("healthy", "brownout"), ("brownout", "shed")]:
        fail(f"overload: the SLA frontend's /debug/overload {snap}")
    for line in ("dynamo_tpu_overload_state 2",
                 'dynamo_tpu_overload_transitions_total{to="brownout"} 1',
                 'dynamo_tpu_overload_transitions_total{to="shed"} 1'):
        if line not in metrics:
            fail(f"overload: the SLA frontend's /metrics lacks {line!r}")
    if not re.search(r'^dynamo_tpu_overload_shed_total\{reason="brownout_shed"\} [1-9]',
                     metrics, re.M):
        fail("overload: the SLA frontend's /metrics counts no brownout shed")
    out["sla"] = {"itl_sla_ms": float(OVERLOAD_SLA["DYN_TPU_OVERLOAD_ITL_SLA_MS"]),
                  "probes": probes, "itl_p50_ms": snap["itl_p50_ms"],
                  "clamped_tokens": clamp["usage"]["completion_tokens"],
                  "transitions": snap["transitions"], "sheds": snap["sheds"],
                  "long_stream_latency_ms": http_latency_ms([long_rec], [0]),
                  "shed_503_before_stream_end_s": long_rec["t_end"] - shed_503["t_end"]}
    # the two extra frontends end on SIGTERM
    for name in ("frontend caps", "frontend sla"):
        p = m.procs[name]
        m.everyone.remove((name, p))
        p.proc.send_signal(signal.SIGTERM)
        try:
            rc = p.proc.wait(timeout=MAINS_GRACE_S)
        except subprocess.TimeoutExpired:
            fail(f"overload: the {name} did not exit within {MAINS_GRACE_S} s of SIGTERM")
        if rc != 0:
            fail(f"overload: the {name} exited {rc} on SIGTERM: {p.tail()}")
    await m.clear()
    return out


class HeldStream:
    """A streamed request whose frames a task reads (and counts) until
    ``close()`` drops the connection, as a client that leaves."""

    @classmethod
    async def open(cls, port, body, headers):
        self = cls()
        self.reader, self.writer = await asyncio.open_connection("127.0.0.1", port)
        data = json.dumps(body).encode()
        extra = "".join(f"{k}: {v}\r\n" for k, v in headers.items())
        self.writer.write((f"POST /v1/completions HTTP/1.1\r\nHost: 127.0.0.1\r\n"
                           f"Content-Type: application/json\r\nContent-Length: {len(data)}"
                           f"\r\n{extra}\r\n").encode() + data)
        await self.writer.drain()
        self.frames, self.done, self._tail = 0, False, b""
        self.task = asyncio.ensure_future(self._read())
        return self

    async def _read(self):
        while chunk := await self.reader.read(65536):
            self.frames += chunk.count(b"data: ")
            self._tail = (self._tail + chunk)[-32:]
            self.done = self.done or b"data: [DONE]" in self._tail

    def close(self):
        self.task.cancel()
        self.writer.close()


async def _full(m, wid):
    """Worker ``wid``'s stats once its 16 slots are taken, else None."""
    s = await m.stats(wid)
    return s if s["active_seqs"] >= 16 else None


def tick_retry_phase(torch, smi) -> None:
    """The engine's tick retry on the card: Qwen2.5-0.5B in process at the
    engine's defaults (CUDA graphs, depth 2; the embedding scaled by
    QWEN_EMBED_SCALE so that attention decides the stream) serves a greedy
    stream and a penalised one (the processor bursts, whose penalty counts
    the abort rebuilds), each unpoisoned, then under a FaultPlan poisoning
    hit 2 of ENGINE_TICK_DISPATCH, then of ENGINE_TICK_REAP, then with the
    runner's 2nd decode_dispatch failing after it wrote the device state
    ("synced") and after it enqueued its graph replay ("enqueued"). Each
    poisoned stream must equal its unpoisoned one, with one failure each."""
    from dynamo_tpu_torch.engines.gpu.engine import TorchEngine, TorchEngineArgs
    from dynamo_tpu_torch.llm.protocols.common import (
        PreprocessedRequest, SamplingOptions, StopConditions,
    )
    from dynamo_tpu_torch.models.config import qwen2_500m_config
    from dynamo_tpu_torch.runtime import fault_names, faults
    from dynamo_tpu_torch.runtime.context import Context

    t_phase = time.monotonic()
    cfg = qwen2_500m_config()
    args = TorchEngineArgs(config=cfg, block_size=16, num_kv_blocks=2048, max_num_seqs=16,
                           max_model_len=2048, prefill_chunk=512, seed=0, device=DEV)
    engine = TorchEngine(args, scaled_params(torch, cfg, args, QWEN_EMBED_SCALE))
    prompt = [(i * 7919 + 13) % 150_000 for i in range(300)]
    samplings = {"greedy": dict(temperature=0.0),
                 "penalised": dict(temperature=0.0, frequency_penalty=0.7,
                                   repetition_penalty=1.3)}

    async def one(sampling):
        req = PreprocessedRequest(token_ids=prompt, request_id="tick",
                                  sampling=SamplingOptions(**samplings[sampling]),
                                  stop=StopConditions(max_tokens=64, ignore_eos=True))
        ids = []
        async for out in engine.generate(req, Context()):
            if out.error:
                fail(f"tick_retry: the {sampling} stream failed: {out.error}")
            ids += out.token_ids
        await idle_cleared(engine)
        return ids

    async def failing_dispatch(sampling, when):
        """one(sampling) with the runner's 2nd decode_dispatch raising
        ``when`` it has synced or enqueued; the dispatches it saw."""
        real, calls = engine.runner.decode_dispatch, []

        def dispatch(*a, **k):
            calls.append(when)
            if len(calls) == 2:
                if when == "enqueued":
                    real(*a, **k)
                raise RuntimeError(f"dispatch failed {when}")
            return real(*a, **k)

        engine.runner.decode_dispatch = dispatch
        try:
            return await one(sampling), calls
        finally:
            engine.runner.decode_dispatch = real

    async def run():
        got = {}
        try:
            for sampling in samplings:
                await one(sampling)  # the stream's graphs captured
                t0 = time.monotonic()
                want = await one(sampling)
                got[sampling, "unpoisoned"] = (want, None, time.monotonic() - t0)
                for point in (fault_names.ENGINE_TICK_DISPATCH, fault_names.ENGINE_TICK_REAP):
                    plan = faults.FaultPlan(seed=3, rules=(faults.FaultRule(
                        point=point, at=(2,), kind="error"),))
                    with faults.armed(plan) as plane:
                        t0 = time.monotonic()
                        ids = await one(sampling)
                        got[sampling, point] = (ids, list(plane.trace), time.monotonic() - t0)
                for when in ("synced", "enqueued"):
                    t0 = time.monotonic()
                    ids, calls = await failing_dispatch(sampling, when)
                    got[sampling, when] = (ids, calls, time.monotonic() - t0)
            return got
        finally:
            await engine.stop()

    got = asyncio.run(run())
    for (sampling, seam), (ids, trace, _) in got.items():
        want = got[sampling, "unpoisoned"][0]
        if seam == "unpoisoned":
            if len(want) != 64:
                fail(f"tick_retry: the unpoisoned {sampling} stream has {len(want)} tokens")
            continue
        if seam in ("synced", "enqueued"):
            if len(trace) <= 2:
                fail(f"tick_retry: the {sampling} stream failing {seam} saw {len(trace)} "
                     "dispatches")
        elif trace != [(seam, 2, 0, "error")]:
            fail(f"tick_retry: {seam} injected {trace}")
        if ids != want:
            at = next((k for k, (a, b) in enumerate(zip(ids, want)) if a != b), len(ids))
            fail(f"tick_retry: failing at {seam}, the {sampling} stream parts from the "
                 f"unpoisoned one at token {at}")
    emit({"phase": "tick_retry", "model": cfg.name, "tokens": 64,
          "graphs": len(engine.runner.graphs),
          "stream_s": {f"{sampling}/{seam}": t for (sampling, seam), (_, _, t) in got.items()},
          "seconds": time.monotonic() - t_phase, "card": smi})


PERF_KNOBS = {"DYN_TPU_PERF_EVAL_INTERVAL_S": "0.2", "DYN_TPU_PERF_MIN_SAMPLES": "8"}
PERF_STREAMS = 4  # concurrent requests a run of the perf phase
PERF_PROMPT = 280  # tokens: with PERF_TOKENS every burst stays in width bucket 32
PERF_TOKENS = 200


def perf_phase(torch, smi) -> dict:
    """The perf ledger's sentinel on the card: Qwen2.5-0.5B in this process,
    three engines on the same weights, each with a perf ledger of its own
    (the process-global one made anew), PERF_KNOBS set through the
    environment and DYN_TPU_PERF_FINGERPRINT_PATH a file of the phase. The
    same traffic (PERF_STREAMS requests of PERF_PROMPT tokens, PERF_TOKENS
    each, one width bucket) through each: a run with graphs stores its
    fingerprints at stop(); a second run with graphs loads them and raises
    no anomaly; a third with cuda_graphs=False, the eager burst that PERF.md
    section 5 reads at ~6x a replayed one, loads the same file and must
    reach verdict ``regression`` with a step_regression anomaly, counted on
    dynamo_tpu_perf_anomalies_total and recorded in the perf ring. Returns
    the launch counts of the three runs."""
    import tempfile

    from dynamo_tpu_torch.engines.gpu.engine import TorchEngine, TorchEngineArgs
    from dynamo_tpu_torch.llm.protocols.common import (
        PreprocessedRequest, SamplingOptions, StopConditions,
    )
    from dynamo_tpu_torch.models.config import qwen2_500m_config
    from dynamo_tpu_torch.runtime import perf_ledger
    from dynamo_tpu_torch.runtime.context import Context

    t_phase = time.monotonic()
    cfg = qwen2_500m_config()
    base = dict(config=cfg, block_size=16, num_kv_blocks=2048, max_num_seqs=16,
                max_model_len=2048, prefill_chunk=512, seed=0, device=DEV)
    params = scaled_params(torch, cfg, TorchEngineArgs(**base), QWEN_EMBED_SCALE)
    prompts = [[(i * 7919 + 13 * (r + 1)) % 150_000 for i in range(PERF_PROMPT)]
               for r in range(PERF_STREAMS)]

    async def traffic(engine):
        async def one(prompt):
            req = PreprocessedRequest(token_ids=prompt, sampling=SamplingOptions(temperature=0.0),
                                      stop=StopConditions(max_tokens=PERF_TOKENS, ignore_eos=True))
            n = 0
            async for out in engine.generate(req, Context()):
                if out.error:
                    fail(f"perf: a stream failed: {out.error}")
                n += len(out.token_ids)
            if n != PERF_TOKENS:
                fail(f"perf: a stream gave {n} tokens")

        try:
            await asyncio.gather(*(one(p) for p in prompts))
            await idle_cleared(engine)
        finally:
            await engine.stop()

    saved = {k: os.environ.get(k) for k in (*PERF_KNOBS, "DYN_TPU_PERF_FINGERPRINT_PATH")}
    runs, counts = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "fingerprints.json")
        os.environ.update({**PERF_KNOBS, "DYN_TPU_PERF_FINGERPRINT_PATH": path})
        try:
            for mode, graphs in (("graphs, stores", True), ("graphs, loads", True),
                                 ("eager, loads", False)):
                perf_ledger._LEDGER = None  # this engine's own ledger
                engine = TorchEngine(TorchEngineArgs(**base, cuda_graphs=graphs), params)
                led = engine._perf
                loaded = led._fingerprints_loaded
                reset_counts()
                t0 = time.monotonic()
                asyncio.run(traffic(engine))
                wall = time.monotonic() - t0
                for n, c in read_counts().items():
                    counts[n] = counts.get(n, 0) + c
                with open(path) as f:
                    stored = json.load(f)["fingerprints"]
                snap = led.snapshot()
                runs.append({
                    "mode": mode, "fingerprints_loaded": loaded, "wall_s": wall,
                    "rows": [{k: r.get(k) for k in ("width", "variant", "path", "samples",
                                                     "step_p50_s", "toks_per_sec",
                                                     "roofline_fraction")}
                             for r in snap["decode"]],
                    "verdicts": {k: {f: v.get(f) for f in ("verdict", "samples", "step_p50_s",
                                                           "toks_per_sec", "anomalies")}
                                 for k, v in snap["verdicts"].items()},
                    "anomalies_total": snap["anomalies_total"],
                    "anomaly_events": [e for e in led.flight.snapshot() if e["kind"] == "anomaly"],
                    "anomalies_metric": re.findall(
                        r'^dynamo_tpu_perf_anomalies_total\{kind="(\w+)"\} (\S+)$',
                        led.render(), re.M),
                    "stored": sorted(stored)})
                del engine, led
                gc.collect()
        finally:
            perf_ledger._LEDGER = None
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    stores, warm, eager = runs
    if stores["fingerprints_loaded"] != 0 or not stores["stored"]:
        fail(f"perf: the first run loaded {stores['fingerprints_loaded']} fingerprints and "
             f"stored {stores['stored']}")
    for run in (warm, eager):
        if run["fingerprints_loaded"] < 1:
            fail(f"perf: the {run['mode']} run loaded no fingerprints")
    if warm["anomalies_total"] or warm["anomaly_events"] or not warm["verdicts"] or any(
            v["verdict"] not in ("ok", "improved") for v in warm["verdicts"].values()):
        fail(f"perf: the second run on the same traffic: {warm['verdicts']}, "
             f"{warm['anomalies_total']} anomalies")
    regressed = [v for v in eager["verdicts"].values() if v["verdict"] == "regression"
                 and any(a["kind"] == "step_regression" for a in v.get("anomalies") or ())]
    metric = sum(float(v) for kind, v in eager["anomalies_metric"] if kind == "step_regression")
    if not regressed or eager["anomalies_total"] < 1 or metric < 1 or not eager["anomaly_events"]:
        fail(f"perf: the eager run: verdicts {eager['verdicts']}, anomalies "
             f"{eager['anomalies_total']} (metric {eager['anomalies_metric']}), ring "
             f"{eager['anomaly_events']}")
    print(f"perf: knobs {PERF_KNOBS}", flush=True)
    emit({"phase": "perf", "model": cfg.name, "knobs": PERF_KNOBS, "streams": PERF_STREAMS,
          "prompt": PERF_PROMPT, "tokens": PERF_TOKENS, "runs": runs,
          "launches": {n: counts.get(n, 0) for n in ("paged_attention_decode",
                                                     "paged_attention_chunk")},
          "seconds": time.monotonic() - t_phase, "card": smi})
    return counts


def fused_ledger_line(engine, smi) -> None:
    """The Llama-3-8B int8 engine's perf ledger (made anew before the
    engine): its decode rows must run the fused layer (path "fused"), each
    with a roofline fraction in (0, 1.05]; printed with that fraction."""
    snap = engine._perf.snapshot()
    rows = [r for r in snap["decode"] if r["path"] == "fused" and r["samples"] > 0]
    others = [r for r in snap["decode"] if r["path"] != "fused"]
    if not rows or others or not all(0 < r.get("roofline_fraction", 0) <= 1.05 for r in rows):
        fail(f"perf_int8: the fused engine's ledger rows {snap['decode']}")
    emit({"phase": "perf_int8", "model": engine.config.name, "identity": snap["identity"],
          "rows": [{k: r.get(k) for k in ("width", "variant", "path", "samples", "step_p50_s",
                                          "toks_per_sec", "occupancy_p50", "avg_ctx_p50",
                                          "roofline_fraction")} for r in rows],
          "card": smi})


# Faults the probe can plant, in memory only, to see what the dense check
# of an engine phase reads when the engine is wrong.
FAULTS = {
    "none": "no fault",
    "pos": "the burst's carry does not advance pos (each burst rewrites the same positions)",
    "window": "decode attention (C = 1) ignores the sliding window",
    "kv_scale": "int8 KV scales stored 5 % high (K and V read back 5 % large)",
    # the fused decode never calls llama.paged_attention: these reach it
    "fused_window": "the fused layer ignores the sliding window (every layer global)",
    "fused_rope": "the fused decode takes the global rope table on the local layers",
    # the processors: the output counts stay as reset at install
    "counts": "a burst never records its tokens into the penalty counts",
}


@contextlib.contextmanager
def planted(fault):
    """While on: the engine runs with ``fault`` (FAULTS). The dense
    reference takes none of the patched functions (it attends densely and
    quantizes through ops/kv_quant)."""
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.ops import attention, logits_process

    saved = [(llama, "decode_burst", llama.decode_burst),
             (llama, "paged_attention", llama.paged_attention),
             (attention, "quantize_kv_chunk", attention.quantize_kv_chunk),
             (llama, "fused_decoder_layer", llama.fused_decoder_layer),
             (llama, "_fused_layers", llama._fused_layers),
             (logits_process, "record_tokens", logits_process.record_tokens)]
    if fault == "pos":
        burst = llama.decode_burst

        def stuck(params, config, state, *a, num_steps, **kw):
            burst(params, config, state, *a, num_steps=num_steps, **kw)
            state["pos"].sub_(state["active"] * num_steps)
        llama.decode_burst = stuck
    elif fault == "window":
        attend = llama.paged_attention
        llama.paged_attention = lambda q, *a, window=0, **kw: attend(
            q, *a, window=0 if q.shape[1] == 1 else window, **kw)
    elif fault == "kv_scale":
        quantize = attention.quantize_kv_chunk

        def high(x):
            q8, scale = quantize(x)
            return q8, scale * 1.05
        attention.quantize_kv_chunk = high
    elif fault == "fused_window":
        layer = llama.fused_decoder_layer
        llama.fused_decoder_layer = lambda *a, window=0, **kw: layer(*a, window=0, **kw)
    elif fault == "fused_rope":
        layers = llama._fused_layers

        def global_rope(params, c, x, cos, sin, cos_loc, sin_loc, *a):
            return layers(params, c, x, cos, sin, cos, sin, *a)
        llama._fused_layers = global_rope
    elif fault == "counts":
        logits_process.record_tokens = lambda state, tokens, active: state
    elif fault != "none":
        raise ValueError(f"unknown fault {fault!r} (one of {sorted(FAULTS)})")
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def probe(torch, smi, specs) -> None:
    """``python3 chip_smoke.py --probe qwen:0.03,0.1:none,pos gemma3:0.01``:
    for each MODEL:SCALES[:FAULTS] (models qwen, gemma2, gemma3 — int8
    weights and KV —, gemma3bf — int8 weights over bf16 pools, the fused
    layer — and gemma3bf_unfused; faults of FAULTS, default none), the
    model's engine phase (its request set, the dense check without limits)
    at each embedding scale with each fault planted: the measurement the
    scales and limits of the dense checks are chosen from. MODEL+procs
    (qwen+procs, gemma3bf+procs) runs the processors phase on the same
    weights after it, also without limits. Each *_reference line says
    whether attention decides the stream (repeats_input_share) and how
    closely the engine follows the reference (exact_argmax, median_rank,
    mean_logit_gap, max_logit_gap, beside random_token_gap). Prints no
    result line."""
    from dynamo_tpu_torch.models.config import (
        gemma2_2b_config, gemma3_1b_config, qwen2_500m_config,
    )

    long = dict(max_model_len=8192, extra_lengths=(4600,))
    gemma3 = dict(long, slots=32, n_short=29, max_tokens=256, quantization="int8")
    paths = {
        "qwen": (qwen2_500m_config, {}),
        "gemma2": (gemma2_2b_config, long),
        "gemma3": (gemma3_1b_config, dict(gemma3, kv_cache_dtype="int8")),
        "gemma3bf": (gemma3_1b_config, gemma3),
        "gemma3bf_unfused": (gemma3_1b_config, dict(gemma3, use_megakernel=False)),
    }
    for spec in specs:
        model, scales, *rest = spec.split(":")
        model, procs = model.split("+")[0], model.endswith("+procs")
        make, kw = paths[model]
        for scale in (float(x) for x in scales.split(",")):
            for fault in (rest[0].split(",") if rest else ["none"]):
                phase = f"probe_{model}_x{scale}_{fault}"
                try:  # a check the fault trips ends this run, not the probe
                    with planted(fault):
                        _, engine, _ = engine_phase(torch, smi, make(), (), None, phase,
                                                    embed_scale=scale, **kw)
                        if procs:
                            args, params = engine.args, engine.runner.params
                            del engine
                            procs_phase(torch, smi, args, params, f"{phase}_procs")
                except SystemExit:
                    emit({"phase": phase, "failed_a_check": True})
                engine = args = params = None
                gc.collect()
                torch.cuda.empty_cache()


def main() -> int:
    if sys.argv[1:2] == ["--runtime-worker"]:
        return runtime_worker()
    if sys.argv[1:2] == ["--mains-worker"]:
        return mains_worker()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from dynamo_tpu_torch.ops.cuda import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    emit({"phase": "device", "name": name, "smi": smi, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.monotonic()
    from dynamo_tpu_torch.tools import fused_layer_phases

    sources = sorted(p[:-3] for p in os.listdir(build.CSRC) if p.endswith(".cu"))
    # One nvcc per source, all started together, and the fused layer's
    # stamped copy for its phase timer beside them.
    with ThreadPoolExecutor(len(sources) + 1) as pool:
        stamped = pool.submit(fused_layer_phases.stamped_library)
        builts = list(pool.map(build.build, sources))
        stamped.result()
    for src, b in zip(sources, builts):
        for line in b.ptxas:
            print(f"[ptxas {src}] {line.strip()}", flush=True)
    emit({"phase": "build", "sources": sources, "seconds": time.monotonic() - t0})
    if sys.argv[1:2] == ["--probe"]:
        probe(torch, smi, sys.argv[2:])
        return 0
    if sys.argv[1:2] == ["--frame-probe"]:
        frame_probe(torch, smi)
        return 0

    worst, timed = kernel_phases(torch)
    worst8, timed8 = int8_kernel_phases(torch)
    for k, v in worst8.items():
        worst[k] = max(worst.get(k, 0.0), v)
    timed.update(timed8)
    for k, v in bs128_phase(torch).items():
        worst[k] = max(worst.get(k, 0.0), v)
    worst_proto, timed_proto = proto_kernel_phases(torch)
    worst.update(worst_proto)
    timed.update(timed_proto)
    counts_attn, counts_ffn = prof_paths(torch, smi)

    from dynamo_tpu_torch.models.config import (
        gemma2_2b_config, gemma3_1b_config, llama3_8b_config, qwen2_500m_config,
    )

    # The embedding is scaled by QWEN_EMBED_SCALE and the gap limit is
    # QWEN_GAP_LIMIT (see there).
    counts, engine, _ = engine_phase(torch, smi, qwen2_500m_config(),
                                  ("paged_attention_decode", "paged_attention_chunk"),
                                  QWEN_GAP_LIMIT, "engine", embed_scale=QWEN_EMBED_SCALE)
    profile_phase(torch, engine.runner, smi)
    # The processors and logprobs on the same weights (the unfused burst).
    args, params = engine.args, engine.runner.params
    del engine
    engine = procs_phase(torch, smi, args, params, "procs", gap_limit=QWEN_GAP_LIMIT,
                         logprob_limit=QWEN_PROCS_LOGPROB_LIMIT,
                         top_overlap_limit=QWEN_PROCS_TOP_OVERLAP)
    variant_costs(torch, engine.runner, smi, "procs", ctx_step=80)
    del engine, params
    gc.collect()
    torch.cuda.empty_cache()
    # Text in, text out: the OpenAI pipeline over the engine, and cli run.
    counts_pipe = pipeline_phase(torch, smi)
    gc.collect()
    torch.cuda.empty_cache()
    cli_batch_phase(smi)
    # The same over HTTP: the OpenAI frontend in-process, and cli run --input http.
    counts_http, http_set = http_phase(torch, smi)
    gc.collect()
    torch.cuda.empty_cache()
    cli_http_phase(smi)
    # The same engine as a worker process behind the runtime's planes (discd,
    # TCP, the event broker), this process its client.
    counts_tcp = runtime_tcp_phase(smi)
    # Two such worker processes publishing KV events and load, this process
    # their frontend with the KV router: prefix groups follow the cache.
    counts_kv = kv_router_phase(smi)
    # The deployment: discd, two `python -m dynamo_tpu_torch.worker`
    # processes and `python -m dynamo_tpu_torch.frontend`; a killed worker's
    # stream migrates. Then the engine's tick retry in this process.
    counts_mains = mains_phase(smi, http_set)
    tick_retry_phase(torch, smi)
    gc.collect()
    torch.cuda.empty_cache()
    # The perf ledger's sentinel: stored, loaded, and a slower path flagged.
    counts_perf = perf_phase(torch, smi)
    gc.collect()
    torch.cuda.empty_cache()
    from dynamo_tpu_torch.runtime import perf_ledger

    perf_ledger._LEDGER = None  # the 8B int8 engine's ledger of its own
    # Llama-3-8B, random int8 weights: the fused layer's gate turns it on.
    # Random weights give logits ~ N(0, 1); the dense check's layers round
    # q/k/v to bf16 where the fused layer keeps f32, which moves logits by a
    # few hundredths, so a chosen token may trail the dense argmax by that.
    counts8, engine, _ = engine_phase(torch, smi, llama3_8b_config(),
                                   ("fused_decoder_layer", "lm_head_int8",
                                    "paged_attention_chunk"), 0.5, "engine_int8",
                                   quantization="int8")
    if not engine.runner.use_megakernel:
        fail("the fused layer's gate did not turn it on for Llama-3-8B int8")
    fused_ledger_line(engine, smi)
    profile_phase(torch, engine.runner, smi, "profile_int8")
    del engine
    gc.collect()
    torch.cuda.empty_cache()

    worst8kv, timed8kv = int8kv_kernel_phases(torch)
    worst.update(worst8kv)
    timed.update(timed8kv)
    # Llama-3-8B, int8 weights and int8 KV pools: the gate turns the fused
    # layer off, so every layer runs unfused — the int8-pool attention
    # kernels and seven int8 products a layer. The dense check's reference
    # reads K and V through the int8 pools' round trip (int8_round_trip);
    # the 8B limit stays 0.5.
    counts8kv, engine, steps8kv = engine_phase(
        torch, smi, llama3_8b_config(),
        ("paged_attention_decode_int8", "paged_attention_chunk_int8", "int8_matmul",
         "lm_head_int8"), 0.5, "engine_int8kv", slots=32, n_short=29, max_tokens=256,
        quantization="int8", kv_cache_dtype="int8")
    check_int8kv_path(engine, counts8kv, steps8kv)
    profile_phase(torch, engine.runner, smi, "profile_int8kv", ctx_step=25,
                  exact=int8kv_burst_launches(engine))
    # _prof_8b.py's path on the same int8 Llama-3-8B weights (not built twice)
    counts_8b = prof_8b_phase(torch, smi, engine.runner.params, engine.config)
    del engine
    gc.collect()
    torch.cuda.empty_cache()

    for k, v in d256_kernel_phases(torch).items():
        worst[k] = max(worst[k], v)
    # Gemma-2-2B at full width, random bf16 weights: every layer unfused
    # (the fused layer's gate says no to bf16 weights), both bf16-pool
    # attention kernels at head_dim 256, the tied head a torch.matmul. The
    # 4,600-token request is prefilled in 9 chunks of up to 512; from its
    # ninth chunk on, the 4,096-key window of the 13 local layers masks in
    # the chunk kernel and in every decode step, and the dense check holds
    # that request against dense_chunk_attention's window.
    # The embedding is scaled by GEMMA2_EMBED_SCALE and the gap limit is
    # GEMMA2_GAP_LIMIT (see there).
    cfg_g = gemma2_2b_config()
    counts_g, engine, steps_g = engine_phase(
        torch, smi, cfg_g, ("paged_attention_decode", "paged_attention_chunk"),
        GEMMA2_GAP_LIMIT, "engine_gemma2", max_model_len=8192, extra_lengths=(4600,),
        embed_scale=GEMMA2_EMBED_SCALE)
    if counts_g["paged_attention_decode"] < cfg_g.n_layers * steps_g:
        fail(f"paged_attention_decode launched {counts_g['paged_attention_decode']} times, "
             f"fewer than {cfg_g.n_layers} layers x {steps_g} decode steps")
    others = {n: counts_g[n] for n in ("fused_decoder_layer", "lm_head_int8", "int8_matmul",
                                       "paged_attention_decode_int8",
                                       "paged_attention_chunk_int8") if counts_g[n]}
    if others:
        fail(f"kernels of other paths launched on the Gemma-2-2B path: {others}")
    steps = engine.args.decode_steps
    profile_phase(torch, engine.runner, smi, "profile_gemma2", exact={
        "paged_attention_decode": cfg_g.n_layers * steps, "paged_attention_chunk": 0,
        "fused_decoder_layer": 0, "lm_head_int8": 0, "int8_matmul": 0,
        "paged_attention_decode_int8": 0, "paged_attention_chunk_int8": 0})
    del engine
    gc.collect()
    torch.cuda.empty_cache()

    for k, v in gemma3_int8_kernel_phases(torch).items():
        worst[k] = max(worst[k], v)
    # Gemma-3-1B at full width, random int8 weights and int8 KV pools: the
    # fused layer's gate says no to int8 pools, so every layer runs unfused —
    # both int8-pool attention kernels at head_dim 256, seven int8 products
    # a layer at d 1,152, and the tied int8 head at V 262,144. The
    # 4,600-token request crosses the 512-key window of the local layers
    # in its second chunk and in every decode step, while the four global
    # layers attend over its whole history. The embedding is scaled by
    # GEMMA3_EMBED_SCALE; the limits are GEMMA3_MEDIAN_RANK_LIMIT and
    # GEMMA3_MEAN_GAP_SHARE (see there, with the planted faults they catch;
    # no limit on a single token's gap).
    cfg_3 = gemma3_1b_config()
    counts_3, engine, steps_3 = engine_phase(
        torch, smi, cfg_3, ("paged_attention_decode_int8", "paged_attention_chunk_int8",
                            "int8_matmul", "lm_head_int8"), None,
        "engine_gemma3_int8kv", slots=32, n_short=29, max_tokens=256, max_model_len=8192,
        extra_lengths=(4600,), embed_scale=GEMMA3_EMBED_SCALE,
        median_rank_limit=GEMMA3_MEDIAN_RANK_LIMIT, mean_gap_share=GEMMA3_MEAN_GAP_SHARE,
        quantization="int8", kv_cache_dtype="int8")
    check_int8kv_path(engine, counts_3, steps_3)
    profile_phase(torch, engine.runner, smi, "profile_gemma3_int8kv", ctx_step=25,
                  exact=int8kv_burst_launches(engine))
    del engine
    gc.collect()
    torch.cuda.empty_cache()

    worst["fused_decoder_layer"] = max(worst["fused_decoder_layer"],
                                       gemma3_fused_layer_phase(torch, smi))
    # Gemma-3-1B at full width, random int8 weights over bf16 pools: the
    # fused layer's gate turns it on (ROADMAP A1), so every decode step is
    # 26 fused-layer launches at D 256, G 4, KH 1 (a 512-key window with the
    # local rope table on 5 of every 6 layers) and the tied int8 head at V
    # 262,144; prefill past the first chunk runs the bf16 chunk kernel at D
    # 256. The int8-KV phase's request set, the embedding scaled by
    # GEMMA3_EMBED_SCALE, limits GEMMA3BF_* (see there).
    counts_3bf, engine, steps_3bf = engine_phase(
        torch, smi, cfg_3, ("fused_decoder_layer", "paged_attention_chunk", "lm_head_int8"),
        GEMMA3BF_GAP_LIMIT, "engine_gemma3_int8", slots=32, n_short=29, max_tokens=256,
        max_model_len=8192, extra_lengths=(4600,), embed_scale=GEMMA3_EMBED_SCALE,
        median_rank_limit=GEMMA3BF_MEDIAN_RANK_LIMIT, mean_gap_share=GEMMA3BF_MEAN_GAP_SHARE,
        quantization="int8")
    if not engine.runner.use_megakernel:
        fail("the fused layer's gate did not turn it on for Gemma-3-1B int8 over bf16 pools")
    # (the int8 product may run in prefill, where a product has <= 64 rows)
    others = {n: counts_3bf[n] for n in ("paged_attention_decode", "paged_attention_decode_int8",
                                         "paged_attention_chunk_int8") if counts_3bf[n]}
    if others:
        fail(f"kernels of other paths launched on the fused Gemma-3-1B path: {others}")
    profile_phase(torch, engine.runner, smi, "profile_gemma3_int8", ctx_step=25,
                  exact=fused_burst_launches(engine))
    args, params = engine.args, engine.runner.params
    del engine
    # The processors and logprobs on the fused burst, at V 262,144.
    engine = procs_phase(torch, smi, args, params, "procs_gemma3_int8",
                         gap_limit=GEMMA3BF_PROCS_GAP_LIMIT,
                         median_rank_limit=GEMMA3BF_MEDIAN_RANK_LIMIT,
                         mean_gap_share=GEMMA3BF_PROCS_MEAN_GAP_SHARE,
                         logprob_limit=GEMMA3BF_PROCS_LOGPROB_LIMIT)
    variant_costs(torch, engine.runner, smi, "procs_gemma3_int8")
    del engine, params
    gc.collect()
    torch.cuda.empty_cache()
    # The same request set with the fused layer off (use_megakernel=False):
    # the unfused bf16-pool path on the same weights, the fused layer's
    # yardstick end to end (its ITL and its burst's device time a step).
    counts_3u, engine, _ = engine_phase(
        torch, smi, cfg_3, ("paged_attention_decode", "paged_attention_chunk", "int8_matmul",
                            "lm_head_int8"), GEMMA3BF_GAP_LIMIT, "engine_gemma3_int8_unfused",
        slots=32, n_short=29, max_tokens=256, max_model_len=8192, extra_lengths=(4600,),
        embed_scale=GEMMA3_EMBED_SCALE, median_rank_limit=GEMMA3BF_MEDIAN_RANK_LIMIT,
        mean_gap_share=GEMMA3BF_MEAN_GAP_SHARE, quantization="int8", use_megakernel=False)
    layers, steps = cfg_3.n_layers, engine.args.decode_steps
    profile_phase(torch, engine.runner, smi, "profile_gemma3_int8_unfused", ctx_step=25, exact={
        "paged_attention_decode": layers * steps, "int8_matmul": 7 * layers * steps,
        "lm_head_int8": steps, "fused_decoder_layer": 0, "paged_attention_chunk": 0,
        "paged_attention_decode_int8": 0, "paged_attention_chunk_int8": 0})
    del engine
    gc.collect()
    torch.cuda.empty_cache()

    # every chunk case of the run beside SDPA
    emit({"phase": "chunk_cases", "cases": CHUNK_TIMES, "card": smi})
    sources = {"paged_attention_decode": "paged_attention.cu",
               "paged_attention_chunk": "paged_attention.cu",
               "fused_decoder_layer": "fused_layer.cu", "lm_head_int8": "lm_head_int8.cu",
               "paged_attention_decode_int8": "paged_attention.cu",
               "paged_attention_chunk_int8": "paged_attention.cu",
               "int8_matmul": "int8_matmul.cu",
               "decode_packed": "decode_attention_proto.cu",
               "decode_bf16": "decode_attention_proto.cu", "ffn_int8": "ffn_int8.cu"}
    replaces = {
        "paged_attention_decode": "dynamo_tpu/ops/pallas/paged_attention.py:288",
        "paged_attention_chunk": "dynamo_tpu/ops/pallas/paged_attention.py:416",
        "fused_decoder_layer": "dynamo_tpu/ops/pallas/fused_layer.py:712",
        "lm_head_int8": "_prof_head.py:33",
        "paged_attention_decode_int8": "dynamo_tpu/ops/pallas/paged_attention.py:288",
        "paged_attention_chunk_int8": "dynamo_tpu/ops/pallas/paged_attention.py:416",
        "int8_matmul": "_prof_stream.py:56",
        "decode_packed": "_prof_attn.py:113",
        "decode_bf16": "_prof_attn.py:312",
        "ffn_int8": "_prof_fused_ffn.py:116",
    }
    # launches: the six engine paths (Qwen2.5-0.5B bf16, Llama-3-8B int8,
    # Llama-3-8B int8 with int8 KV, Gemma-2-2B bf16, Gemma-3-1B int8 with
    # int8 KV, Gemma-3-1B int8 over bf16 pools, and the latter with the fused
    # layer off), the OpenAI pipeline, the HTTP frontend and the worker
    # process behind the runtime's planes, the two KV-routed worker
    # processes and the two worker mains over Qwen2.5-0.5B and the three
    # profiling paths (prof_attn, prof_fused_ffn,
    # prof_8b's four modes); times of the D 64 (bf16 pools) and D 128 (int8
    # pools) cases, the D 256 and block-size-128 ones above, #5-#7 at their
    # main cases
    paths = (counts, counts8, counts8kv, counts_g, counts_3, counts_3bf, counts_3u, counts_pipe,
             counts_http, counts_tcp, counts_kv, counts_mains, counts_perf, counts_attn,
             counts_ffn, counts_8b)
    emit({"kernels": [
        {"name": n, "route": "cuda", "source": f"dynamo_tpu_torch/csrc/{sources[n]}",
         "replaces": replaces[n], "launches": sum(c.get(n, 0) for c in paths),
         "max_abs_err": worst[n], **timed[n]}
        for n in sources
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
