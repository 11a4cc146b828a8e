#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and hold every
kernel on it against its plain PyTorch twin.

Run from the repo root:  python3 chip_smoke.py

Phases, each fatal on failure:
1. environment: the card's name and power limit, torch and CUDA versions;
2. build: every kernel under deeplearning4j_tpu_torch/csrc with nvcc
   for sm_90a (one nvcc per source, all started together);
3. kernels: the flash-attention forward against its plain twin on the
   card (bf16 3e-2, fp32 2e-5 — the tolerances of
   tests/test_pallas_attention.py), over BERT-base shapes, padded keys,
   causal, ragged T, Tq != Tk, fully masked rows (causal too), fp32 and
   other head dims, and the edges of the wgmma route (serving's B=1
   T=128, an odd count of 64-row tiles with a sequence fully masked,
   D=128 causal T=1024), each case printing its route; then kernel,
   plain twin and F.scaled_dot_product_attention (a yardstick the port
   never calls) timed with CUDA events at BERT's serving shapes and
   GPT-2 small's causal training shape;
4. BERT-base fill-mask serving at full width (12 x 768, 12 heads, vocab
   30522, bf16, seeded random weights) through InferenceEngine +
   DynamicBatcher, with client threads sending mixed requests at T=128
   and one T=512 request through its own engine.  Checks: each future
   gets its own rows, logits are finite and agree with an unpadded
   forward and with the plain-attention forward, and B1 launched exactly
   once per layer per dispatch;
5. BERT-base MLM training (B=32, T=128, dropout 0.1) and
6. GPT-2 small causal-LM training (B=8, T=1024), each through the
   model's make_train_step defaults (flash attention, adamw) at full
   width: 2 warm-up and 10 timed steps on a fixed batch, each block
   recomputed in the backward (cfg.remat).  Checks: the loss is finite
   and falls; B2 and B3 launch once per layer per step and B1 twice
   (forward and recompute); one dropout-0 step's gradients through the
   kernels agree
   with the plain attention's (global relative L2 <= 3e-2), and for
   BERT an fp32-compute step at depth 2 within 1e-4.  Prints step ms,
   tokens/s, the model-FLOPs share of 989 TFLOP/s and a profile of one
   step (B1/B2/B3, forward and backward products, optimizer, fp32 adds
   and fills) and the peak memory.

7. word2vec (the bench.py:676-678 config: D=100, window 5, 5 negatives,
   HS, batch 16,384) on data/text8 (50-word sentences, min count 5):
   masked cold fit, warm refit and one profiled epoch, then exact and
   device pair modes; on a 2M-word Zipf corpus of 71,290 names (cold
   and warm); ParagraphVectors over the labelled text8 sentences.
   Checks: B4 launches once per chunk on every path, finite tables,
   tests/test_nlp.py's text8 neighbour check, and one epoch through B4
   against one through the plain twin with the same draws (1e-4);
8. GloVe (GloveConfig defaults) on text8 and the Zipf corpus: B5
   launches once per chunk, the loss falls, one epoch through B5
   against one through the plain twin with the same permutation.
   Prints words/s and triples/s (host clock after synchronize) and the
   device-busy share of one profiled epoch.
9. LeNet-MNIST (models/lenet.py at full width, seeded weights) on
   data/mnist (2,048 train, 512 test images), B=128: the same params and
   10 seeded random batches through the port on the card and on the CPU
   (per-step losses fp32 rtol 1e-4, bf16 5e-2), 10 data/mnist batches
   the same way (printed, not held: exact max-pool ties there are
   broken by each conv algorithm's rounding), max pooling's tie routing
   card vs CPU (equal), the bf16 dense product with cuBLAS's
   reduced-precision reduction on and off; fit_backprop and
   fit_iterator for 2 epochs each (bf16), then evaluate on the test
   split (accuracy >= 0.90); a warmed serving engine's mixed-size
   stream against the unpadded forward (bf16 3e-2, fp32 2e-5); the
   step's time (median of 207 synchronized steps, and the staged path
   between CUDA events), the busy share and device ms by kernel kind of
   one profiled epoch, peak memory.  No hand kernel runs here (the
   path is cuDNN and cuBLAS): their launch counts must stay 0.
10. GPT-2 small generation serving (gpt.gpt_config() at full width and
   depth, bf16, seeded random weights): (a) 4 prompts of 128 tokens,
   64 greedy tokens through gpt.generate, its prefill and step logits
   teacher-forced against forward_logits over prompt + tokens (bf16 5e-2,
   fp32 1e-3) and its tokens against the dense argmax wherever the
   dense top-2 margin exceeds the bar; (b) a seeded burst of 32 requests
   (prompts 16-512, 64 tokens, half greedy, half sampled at 0.8 with
   their own seeds) through DecodeEngine(n_slots=8, buckets 32-1024) +
   ContinuousBatcher: TTFT and per-step latency p50/p99 and tokens/s,
   against its first 8 requests as sequential solo generate calls;
   requests join mid-flight and every slot is free at the end; every sampled
   request gives the same tokens resubmitted alone; one decode step of
   8 slots in bucket 1024 timed (host) and profiled (device ms,
   kernels), the burst profiled for its busy share; the burst in fp32,
   each greedy request token-identical to its solo generate up to the
   solo run's first step of top-2 margin below 1e-3; (c) the burst with
   int8 weights + int8 KV and with bf16 weights (tokens/s,
   kv_bytes_per_slot, the dequantization's ms a dispatch, greedy
   agreement with full precision), int8 on the card against the port's
   CPU (round trip within scale / 2, payloads, prefill logits within 5%
   of their scale: tests/test_serving_tier2.py:70, :204); (d) GPT
   scoring through InferenceEngine(gpt.make_serving_apply) at T=1024
   causal, buckets 1/2/4: logits within 5e-2 of the plain-attention
   forward, and one row through InferenceEngine(quantize="int8") within
   5e-2 of the plain-attention forward of the dequantized tree; B1 launched 12 times a
   dispatch and never on the decode path.  Every line ends with the card's name and power limit.
11. the compile engine (runtime/compile_cache): each of the five
   captured paths runs the same seeded inputs through its raw function
   (``call.fn``, or every engine entry made eager for the loops) and
   through its CUDA graphs: LeNet fp32 B=128, 20 steps (losses and
   params within 1e-6 relative, cuDNN deterministic for both), then two
   same-conf LeNet fits at once in two threads through the shared step,
   each against its solo eager fit (1e-6); BERT-base MLM B=32 T=128 and
   GPT-2 small B=8 T=1024 (remat), 10 bf16 steps with dropout (loss per
   step, and the relative L2 of the params' change from the initial
   state, within 1e-6), then two BERT states stepped alternately through
   one step_fn, each against its solo eager run (1e-6), the initial
   states unchanged; slot_decode's logits at 8 slots in bucket 1024
   (fp32 1e-5, bf16 5e-2), the 32-request burst and one decode step,
   which must copy no byte into the graphs' buffers; one word2vec and
   one GloVe epoch on text8 (1e-4 relative L2).  Each path prints host ms
   (median of synchronized calls), device ms and the busy share, eager
   beside captured, and holds its steady state to zero new captures;
   the captures per label must equal the signatures the entries hold.
12. self-healing training, checkpoints and run telemetry
   (runtime/{checkpoint,resilience,telemetry,metrics}): (a) ResilientFit
   over LeNet-MNIST (bf16, data/mnist, B=128, 3 epochs, async snapshots
   every 8 steps, cuDNN deterministic) with one batch NaN-poisoned on its
   first read and an injected detector forcing one rollback:
   steps_skipped == 1, rollbacks == 1, params finite; the same run
   stopped at max_steps=20 and resumed with resume=True ends torch.equal
   to the uninterrupted run (final params, and the newest common
   snapshot leaf for leaf, momentum state included); a programmatic
   PreemptionGuard.request() stops at the next boundary with one final
   sync snapshot; no capture after warm-up across all of it; (b) GPT-2
   small's training state (B=8, T=1024, remat, dropout, adamw; B1-B3 on
   the path): 2 steps, an AsyncCheckpointer.save, 2 steps dispatched
   behind it at once, then the snapshot restored into a fresh run that
   replays those 2 steps with the same batches and dropout streams:
   bit-identical to the uninterrupted run, no new capture; the
   checkpointer's pinned pool is reserved for the state before training,
   so the first snapshot's staging is within 5x of a second one's; it
   prints the snapshot's bytes, the training thread's staging ms, the
   writer's commit ms and write-behind lag, and the step's ms (CUDA
   events) with and without a snapshot in flight; (c) the telemetry registry's
   snapshot (all nine counter families, peak_bytes_in_use) and part
   (a)'s journal and Chrome trace, summarized.  Checkpoints go under a
   temporary directory that is removed at the end.
13. MultiLayerNetwork.fit and what it reaches (optimize/{solver,
   line_search,hessian_free}, the RBM and autoencoder, cli.py): (1)
   LeNet-MNIST (fp32, B=128) through net.fit(batches, num_epochs=2), the
   finetune of the output layer through the solver (its scores fall, the
   iterations run before a termination printed) then fit_backprop; test
   accuracy >= 0.90; the finetune's scores against the port's CPU
   finetune on the card's activations (rtol 1e-4); ms a GD iteration and
   the host read's share; (2) prepare_resilient_fit -> ResilientFit:
   params torch.equal to finetune's, 0 captures after warm-up; (3) a deep
   belief net at Hinton, Osindero & Teh (2006)'s MNIST widths
   784-500-500-2000 (binary RBMs, CD-1, 10 steps a batch) on binarized
   data/mnist through fit (pretrain, finetune, one backprop epoch): each
   RBM's reconstruction error falls (mean of its last 10 steps below its
   first 10), test accuracy printed, a second pretrain with the seed
   torch.equal, the device ms of a CD-1 step a layer; the same widths with
   denoising autoencoders (corruption 0.25), whose losses fall; (4) CG
   and L-BFGS (30 iterations) on the DBN's 2000x10 output layer over the
   merged 2,048 rows: the score never rises, card vs CPU on the same
   activations within rtol 1e-4 an iteration with the same line-search
   trials; (5) Hessian-free on Martens (2010)'s curves deep autoencoder
   784-400-200-100-50-25-6-25-50-100-200-400-784 (sigmoid layers, logistic
   outputs under cross-entropy, weights N(0, 9/fan_in)) over
   CurvesDataFetcher(n=20000): 5 outer iterations take the score below
   0.9 of its start, no capture after the first as lambda adapts; ms an
   outer iteration, CG iterations, ms a damped Gauss-Newton product; (6)
   the CLI in subprocesses on the card: train (mnist2d, LeNet conf, one
   epoch), test and predict (the written classes score test's accuracy),
   train
   --checkpoint-dir, the same command refused in one line, --resume; each
   command's wall time; the phase's peak memory.  No hand kernel runs
   here (the path is cuBLAS, cuDNN and torch ops): their launch counts
   must stay 0.

14. GPT-2 small serving at scale (bf16, seeded weights; the draft
   distilgpt2's published shape, 6 x 768): (1) phase 10(b)'s burst through
   a pinned DecodeEngine, a paged one (257 pages of 32 tokens) and one of
   129 pages: every request token-identical across the three, no
   KVPagesExhausted reaches a client, every page back after the drain;
   KV bytes, peak pages, one decode step at bucket 1024 (host ms, device
   ms, kernels) and tokens/s each; (2) 32 requests of one 512-token system
   prompt and 32-96-token tails, cold (harvesting off) and warm, pinned
   with a PrefixCache and paged with resident mounts: warm tokens equal
   cold, >= 31 hits, TTFT p50/p99, the mount's ms; (3) speculative
   decoding, k = 4, 8 prompts of 128 and 128 tokens out, with the
   distilgpt2-shaped draft and with the target as its own: agreement with
   plain in bf16 (greedy and sampled at 0.8) printed; fp32 greedy and
   sampled (0.8), pinned and paged, token-identical to the plain fp32
   engine up to each request's first step of top-2 margin < 1e-3 in its
   drawn scores, the sampled runs holding an acceptance below 1 (the
   reject path); paged + spec + int8 weights and KV through the batcher;
   acceptance, tokens a round, ms a round, tokens/s; (4) rebind_params of
   the part-2 paged engine to a second seeded tree: a busy engine raises,
   0 new captures, the resident registry empty, no hit on the old
   weights' pages, 4 greedy requests equal a fresh engine's; (5)
   Router.replicate(n_replicas=2) on the card, 64 requests from 8 client
   threads (served counts within a quarter), max_queue_depth=2 sheds
   typed OverloadedErrors booked in requests_shed, and an evacuated
   replica's requests replay on the other with the undisturbed tokens;
   (6) cli generate in subprocesses: --train-steps 50 --save-params, then
   --params --temperature 0 twice, identical.  No hand kernel launches in
   parts 1-5; the CLI's training launches are printed and counted.
15. the GPT-2 small serving fleet (bf16, seeded weights, a second seeded
   tree as the new checkpoint): (1) the reference's tier2.autoscale
   drill (bench.py:2233-2290) at full width: 4-slot replicas of one
   32-token bucket, 16-token prompts, 16 tokens out, one submit every 5
   ms, half sampled at 0.8, at least 1,000 requests and five spawn
   times, through a static one-replica Router and an AutoscalingRouter
   of 1-3 replicas (depth bound 5), twice each in the order static,
   autoscaling, autoscaling, static: the autoscaler sheds fewer over
   its two trials, every shed a typed OverloadedError, every accepted
   request token-identical to one undisturbed engine (they were served
   while spawns captured), captures exactly W a factory replica; sheds,
   TTFT, each spawn's factory and capture ms, the submits held behind
   the emergency spawn, the requests accepted a half second and the
   cores and gc pauses the process took printed; then shrunk to one replica and a replica replaced, each
   time memory_allocated back within 64 MiB; (2) swap_weights of two
   paged replicas under a greedy client, bf16 and int8: nothing fails,
   one swap booked, 0 captures, 4 greedy requests equal a fresh engine's
   on the new tree; a one-replica fleet swaps through a temporary replica
   at W captures, its memory given back; (3) the chaos gate
   (serving/chaos_gate.py) at full width; (4) the brownout ladder on a
   paged replica with the distilgpt2-shaped draft and a prefix store:
   levels 0 -> 1 -> 2, no speculative round and no harvest past their
   rung, a typed shed, walked back by idle ticks, 0 captures, every page
   back; (5) eight clients racing close(): each submit completes or
   raises RouterClosed.  No hand kernel launches in phase 15.
16. ResNet-50 and the Mixture-of-Experts LM: (1) ResNet-50 fp32 at B=2
   224x224, card against CPU on one seeded tree, train mode (logits and
   new batch statistics) and inference mode, relative L2 within 1e-3;
   (2) the 7x7/s2 stem against the space-to-depth stem at B=128 (bf16,
   forward and forward+backward ms, the faster printed); (3) ResNet-50
   bf16 B=128 224x224 training through make_train_step's defaults
   (SGD-Nesterov 0.1/0.9, bench.py:443-496's shape), 30 timed steps:
   losses finite, the last below the first timed, no capture after the
   warm-up; step ms, images/s, MFU at bench.py:481's FLOPs, peak memory,
   a profile by layer kind and eager against captured; (4) the trained
   net served through InferenceEngine in buckets 1-64: 7 captures at
   warm-up, requests of 1-64 rows within 5e-2 of the unpadded forward,
   argmax agreement >= 99%, p50/p99 a bucket; (5) three steps captured
   against eager, cuDNN deterministic, at 1e-6; no hand kernel launches
   on ResNet's path; (6) the MoE LM at GPT-2 small's widths (768 x 12,
   12 heads, vocabulary 50,257, 1,024 positions; 8 experts of 3,072,
   top-2, capacity 1.25, aux 1e-2, remat, bf16), B=8 T=1024 through
   make_train_step's defaults (flash attention, adamw 1e-3): 10 timed
   steps, losses finite and falling, B1 2 a layer a step and B2, B3 1,
   no capture after the warm-up; the aux loss and the choices dropped at
   capacity; a profile (B1-B3, products); routing, dispatch + combine
   and the experts of one layer profiled alone beside the reference's
   dense one-hot dispatch; two steps captured against eager at 1e-6;
   the bf16 loss at full depth through the kernels against plain
   attention within 5e-2 with the routing assignments that differ
   printed; fp32 at depth 2, the gradients through the kernels against
   plain attention's within relative L2 1e-4.
17. the sharded-fit spine: (1) GPT-2 small (gpt_config(), 124 M
   params, remat, dropout 0.1) through models/lm_fit.CausalLM.
   fit_backprop with bf16 mixed precision, B=8 T=1024, 4 batches of
   seeded random ids x 3 epochs, SGD lr 0.05 momentum 0.9, after a
   one-step warm-up fit: losses finite, the last epoch's mean below the
   first's, no guard skip, the loss scale at next_loss_scale's value
   for 12 good steps, B1 24 and B2, B3 12 launches a step, no capture;
   step ms, tokens/s, MFU, peak memory and one step's profile by kind;
   (2) at depth 2, two captured steps against the raw step (1e-6), then
   an inf planted in one param: the guard skips, params and momentum
   stay, the scale halves, the next clean step proceeds; (3) fp32 depth
   2: grad_accum=2 against 1 after 3 steps (relative L2 1e-5); (4) part
   1's fit on make_mesh(MeshSpec(data=1)) over an NCCL group of one
   rank (file:// rendezvous in a temp dir): params torch.equal to
   mesh=None, the NCCL kernels' ms in one step's profile; (5) the MoE
   LM of phase 16 through CausalLM, bf16, 3 batches x 2 epochs: losses
   fall, B1 2 and B2, B3 1 a layer a step, no capture, aux and dropped
   choices printed; (6) MultiLayerNetwork's data-parallel bundle, card
   against CPU: LeNet (phase 9's conf and seeded batches) with bf16
   mixed precision (losses 5e-2) and with grad_accum=2 (1e-4), and a
   conv + batch-norm conf's running statistics through bn_collective
   (1e-4); (7) ResilientFit over GPT-2 small bf16 at depth 2, 10 steps,
   a snapshot every 4, a slice stopped after 6 and resumed: torch.equal
   to the uninterrupted run, no capture after the warm-up; (8) fp32 depth 2,
   T=256, 3 steps, the kernels on the card against plain attention on
   the CPU (params' relative L2 1e-4).  B1-B3 launches of parts 1 and 5
   join the kernels line.
18. the rest of the MultiLayerNetwork surface: (a) the char-LSTM
   through nn/api.LSTMSequenceClassifier on data/text8 at the widths of
   DL4J's GravesLSTMCharModellingExample (hidden 200, batch 32, sequence
   1,000; 27 symbols one-hot in and out), bf16 products, truncate_bptt
   on, Adam: one fit step (warm-up runs and the capture of the whole
   step), then 5 timed steps: ms a step, characters/s, captured or
   eager, the loss falls; 200 sampled characters; one step's loss and
   gradients at T=50 on the card against the CPU (fp32 1e-4, the bf16
   loss 2e-2); (b) runtime/native builds native/dl4j_native.cpp into
   build/native/ (a failed build fails the phase with the compiler's
   stderr), LFWDataFetcher decodes data/lfw's 120 JPEGs natively, the
   reference's accuracy tier (784-48-12 relu, lr 0.05, 300 epochs of
   fit_backprop, tests/test_jpeg_lfw.py:160-193) reaches > 0.8, and a
   fresh net through fit_iterator over NativeBatchIterator (the native
   producer) 100 epochs, > 0.8; decode and training times; (c) the
   recursive autoencoder at B=256 T=20 D=100 pretrained through
   MultiLayerNetwork.pretrain (the loss falls), one
   pretrain_value_and_grad card against CPU (1e-4); (d) GraphBuilder's
   docstring graph, compile and grad on the card against the CPU (1e-5),
   20 gradient steps lower the loss; no hand kernel launches in (a)-(d);
   (e) runtime/autotune.sweep_attention, bf16 fwd+bwd, the plain
   attention against B1-B3 (never a library attention) at BERT-base's
   (B=32 T=128) and GPT-2 small's (B=8 T=1024 causal) training shapes
   into a temporary cache: both candidates' ms and the winner; a fresh
   process on that cache sweeps nothing and make_attn_fn(autotune=True)
   reports source="autotuned".  Phases 1-17 and 19 run with the
   autotune cache off (and make_attn_fn reads no cache unless asked), so
   no winner routes them.
19. the model axis (parallel/tensor_parallel.py), on two rank processes
   sharing the one card over gloo with CUDA tensors: (a) a two-rank NCCL
   group on the card, whose error is printed (NCCL refuses two ranks on
   one device); B1-B3 against their plain twins at a rank's shapes (6 of
   GPT-2 small's 12 heads, B=8 T=1024 causal, fp32 and bf16, phase 3's
   tolerances); then, every result held against a mesh=None run on the
   card in this process: (b) GPT-2 small at depth 2 in fp32 through
   CausalLM on data=1 x model=2, 3 seeded batches: the gathered params
   within 1e-5 relative L2, the replicated leaves bit-equal across the
   ranks, B1 2 L launches a step on each rank and B2, B3 L each; (c) the
   same at full depth in bf16 mixed precision, one batch 3 times: the
   loss finite and falling, each step's loss within 2e-2 relative; step
   ms (host clock, eager: a step over gloo is not captured), the model
   axis's collectives a step (calls, bytes, and gloo's ms in one timed
   step), peak memory, and a rank's param bytes against replicated (<=
   0.70; the odd vocabulary keeps the embedding replicated); (d)
   DecodeEngine(mesh=) at GPT-2 small in fp32, 4 prompts x 16 greedy
   tokens equal to the replicated engine's, half its KV bytes a slot;
   (e) BERT-base's make_train_step(cfg, mesh) on model=2, bf16: the loss
   and the gathered gradients within 3e-2 relative L2, then 2 steps'
   losses.  The ranks' launches on (b)-(e) join the kernels line.
20. the model axis for a serving fleet and the expert axis, on two rank
   processes sharing the card over gloo, every result held against a
   replicated or mesh=None run on the card in this process: (a)
   collectives.all_to_all on CUDA tensors (bf16 at (c2)'s inbox shape
   and fp32), split 0 / concat 1 and back, forward and gradient
   bit-equal to a gather-and-slice, one all_to_all_single a call; (b)
   GPT-2 small in fp32 served over the model group, 8 concurrent
   requests x 16 greedy tokens, through Router.replicate(model_degree=2,
   n_replicas=2) and through DecodeEngine(mesh=) + ContinuousBatcher
   with int8 weights, int8 KV and the distilgpt2-shaped draft: tokens
   equal to the replicated engine's with the same knob; KV bytes a slot
   and weight bytes a rank printed; (c1) the MoE LM at GPT-2 small's
   widths, depth 2, fp32, capacity 8, 2 SGD steps through
   moe.make_train_step on data=1 x expert=2: gathered params within
   1e-5 of mesh=None's; (c2) the same at full depth, bf16 mixed
   precision, capacity 1.25, one B=8 T=1024 batch x 3 through CausalLM:
   the loss finite and falling, B1 2 L and B2/B3 L launches a step a
   rank, a rank's expert-table bytes within 0.45-0.55 of the whole; step
   ms (host clock, eager), every collective's calls and bytes a step by
   kind (collectives.stats), and one more step under
   collectives.timed(): gloo's share of it, in all and by kind; (c3)
   (c2) at capacity 8 for one step: the gathered params' change within
   3e-2 relative L2 of mesh=None's, over the expert-split and the
   replicated leaves apart, with the expert tables left at init as a
   control that must read above it; (d) the MoE CausalLM at depth 2 in
   fp32 on data=1 x model=2 within 1e-5 of mesh=None's.  The ranks'
   launches on (b)-(d) join the kernels line.
21. the pipe and seq axes, on two rank processes sharing the card over
   gloo (the ring shift's send and receive staged through the host),
   every result held against a mesh=None run on the card in this
   process: (a) collectives.ring_permute on CUDA tensors, the
   neighbour's block bit-equal, its gradient the inverse shift, one
   tensor's bytes booked; ring attention over B1-B3 against the ring
   over plain blocks at GPT-2 small's attention (B=8 T=1024, 512 tokens
   a rank, 12 heads, D=64, bf16, causal and not): O within phase 3's B1
   bound, dQ/dK/dV within its B2/B3 bound, and B1, B2 and B3 launched
   once a block the schedule visits (causal: 1 on seq rank 0, 2 on rank
   1); Ulysses against the plain full attention; (b) GPT-2 small
   (dropout 0) through CausalLM on data=1 x pipe=2, 4 microbatches,
   B=8 T=1024, SGD 0.05 with momentum 0.9: at depth 2 in fp32 over 3
   seeded batches the gathered params within 1e-5 relative L2 of
   mesh=None's (torch.equal printed), and a control, the tied
   embedding's sum over pipe left out, above it; at depth 6 in bf16
   mixed precision, one batch x 3: each step's loss within 2e-2, a
   rank's block bytes 0.45-0.55 of all the blocks', step ms, every
   collective's calls and bytes by kind and gloo's share of one step
   under collectives.timed(); BERT-base's make_pipeline_train_step
   (B=32 T=128, 4 microbatches): 3 steps' losses within 2e-2 of
   make_train_step's; (c) the same on data=1 x seq=2 (ring attention
   over B1-B3 in every layer), and BERT-base's make_sp_train_step (64
   tokens a rank).  Every path's B1-B3 launches are checked against its
   schedule and join the kernels line.
22. sharded snapshots, the cluster control plane and recovery, on gloo
   rank processes sharing the card (the cluster's key-value store is the
   rendezvous's FileStore, heartbeats 0.2 s / 5 s), GPT-2 small (dropout
   0) through CausalLM under ResilientFit(mesh=, cluster=), B=8 T=1024,
   SGD 0.05 with momentum 0.9, seeded batches in order, every result
   held against this process: (a) two ranks on data=1 x model=2, depth
   2 fp32, a snapshot every 2 for 4 steps: the manifest's layout is
   "sharded", each rank's pieces are 0.45-0.55 of the model-split
   leaves' bytes (its npz file's share of the replicated tree printed),
   the snapshot restored whole here is torch.equal to the ranks'
   gathered params and momentum, and a rank's save ms is printed beside
   the same state gathered and written by rank 0 and phase 17 (7)'s
   gathered snapshots; (b) four ranks on data=2 x model=2, depth 2 fp32,
   ranks 2 and 3 lost at step 5 (DeviceLossChaos on every rank), a
   snapshot every 2, 8 steps: ranks 2 and 3 leave evicted, ranks 0 and
   1 re-mesh to data=1 x model=2 with elastic_accum 2, restore step 4
   from the four ranks' pieces and finish, their gathered params within
   1e-5 relative L2 of the uninterrupted mesh=None grad_accum=2 run here
   (torch.equal printed), a control that loses the momentum at the
   restore outside it (the control with elastic_accum left at 1 is
   printed), B1-B3 launches before and after the re-mesh checked against
   the schedule, the recovery's ms by stage; (c) two ranks on data=2,
   full depth bf16 mixed precision, a snapshot every 3: rank 1 SIGKILLs
   itself at step 5 (its exit code -9 the one death expected); rank 0's
   step collective fails, its heartbeat names rank 1, it shrinks to
   generation 1, restores step 3 and finishes 9 steps alone with
   grad_accum=2, its losses after the recovery within 2e-2 of the
   uninterrupted mesh=None grad_accum=2 run's; the ms from the kill to
   the detection and to the first step after the restore, and the steps
   lost; (d) two ranks on data=2, depth 2 fp32, PreemptionChaos on rank
   1 alone: both stop at one step with one final snapshot committed
   across the cluster, and a resume on data=1 x model=2 finishes within
   1e-5 of the uninterrupted mesh=None run (torch.equal printed).
   (a)+(d), (b) and (c) run side by side (eight ranks) while this
   process runs the references.  The main paths' B1-B3 launches join the
   kernels line.  With a mesh under a cluster the fits read through the
   data service: in (c) rank 0's restored reader cursor is the restored
   step's, the batches it stages after the restore are the uninterrupted
   schedule's from there (none twice, none missing), and a plan
   reassignment is booked.
23. The data-parallel input and training paths, gloo rank pairs sharing
   the card, each against a run in this process: (a) GPT-2 small (depth
   2, fp32, dropout 0, B=8 T=1024, SGD 0.05/0.9) through CausalLM under
   ResilientFit(mesh=data=2, cluster=) over DataService.from_store (4
   seeded batches written by write_sharded_batches into a
   LocalArtifactStore), 2 epochs, a snapshot every 3: each rank stages
   0.45-0.55 of a global batch's bytes a batch (stage ms, the prefetch
   depth's high-water mark and the seed agreements printed), the
   gathered params within 1e-5 relative L2 of mesh=None's, the newest
   manifest's ingest block at divmod(step, 4), B1-B3 launches a rank
   against the schedule; (c) ResNet-50 B=128 224x224 SGD-Nesterov
   0.1/0.9 through resnet.make_train_step(mesh=) at data=2, 64 rows a
   rank: after one fp32 step the params and the batch stats within 1e-3
   relative L2 of mesh=None's, a control with each rank's batch-norm
   moments alone outside that bound in both; then 3 bf16 steps:
   step ms, gloo's share (collectives.timed()), images/s and the gaps
   printed (DP_RESNET_TOL says why the bf16 steps are not held); (d)
   word2vec (pair_mode="device", 1 epoch) and GloVe (2 epochs, as two
   fits) on text8 at D=100 through fit(mesh=) with kernel="cuda": the
   ranks' tables torch.equal to each other after each epoch and within
   1e-5 relative L2 of the mean of the two stripes run here from the
   same tables and draws through B4/B5, B4/B5 launches a rank equal to
   its chunks, words/s or triples/s and the averaging's share printed.
   Then on an NCCL data mesh of one in this process: ResNet-50's
   captured bf16 steps (cuDNN deterministic) torch.equal to mesh=None's,
   the word2vec and GloVe fits within 1e-5 relative L2 of mesh=None's
   (B4 and B5 sum with atomics: mesh=None run twice is printed beside).
   The ranks' B1-B5 launches join the kernels line.
24. The scale-out runtime, every number beside the card's name and power
   limit: (a) GPT-2 small (full width and depth, bf16, seeded weights)
   served by two gloo rank processes sharing the card, on data=1 x
   pipe=2 and then data=1 x seq=2, DecodeEngine(n_slots=8) under
   ContinuousBatcher (rank 0 leads, rank 1 follows its schedule), the
   first 8 requests of phase 10's seeded burst: each rank's tokens
   (recorded on the leader and the follower alike) equal to a mesh=None
   engine's here on the same weights, each rank holding the whole
   served tree; seconds for the burst, B1 launches, weight and KV bytes
   a rank; (b) train_word2vec_distributed (phase 7's text8 config) and
   train_glove_distributed (phase 8's) over 2 in-process workers and 4
   shards: B4 / B5 launch once a chunk, no job failed or dropped, the
   averaged tables within SC_W2V_TOL / SC_GLOVE_TOL relative L2 of the
   same two rounds run by one worker, words/s and triples/s and how far
   the workers' jobs overlap; (c) MultiProcessRunner with 2 spawned
   worker processes on the card (MultiLayerNetworkPerformer, phase 9's
   LeNet conf, 4 jobs of 512 data/mnist images): one worker SIGKILLed
   0.2 s into its first job, the reaper requeues it, the run finishes
   with finite averaged params above chance on the 512-image test
   split; join ms, kill-to-reap and reap-to-retake ms, bytes across the
   wire a round; (d) HogwildTrainer with 2 threads on LeNet-MNIST: every
   job processed, the held-out loss falls, and one worker is
   torch.equal to a plain loop of the same steps (cuDNN deterministic);
   (e) the word-count runner under chaos_factory(p_fail=0.25) gives the
   clean run's counts, and a p_corrupt NaN hook's corruptions are each
   rejected by the WorkAccumulator.  (a)'s ranks serve while this
   process runs (a)'s reference and (b)-(e).  B1 launches of (a)'s
   ranks and B4/B5 launches of (b)'s trainers join the kernels line.
25. NLP and periphery, every time beside the card's name and power
   limit: (a) the RNTN at the reference's published width (dim 25, 5
   classes, max_nodes 64) over 2,304 data/text8 windows of 24 words,
   labelled by SentiWordNet.classify (seven classes onto five) and
   parsed by TreeParser; 2,048 trees fit full-batch for 20 AdaGrad
   epochs from seeded weights (rntn.params_from_numpy): the first 3
   losses within 1e-4 relative of the same fit on the CPU, the loss
   falls, RNTNEval over the 256 held-out trees counts their internal
   nodes; an epoch's ms and trees/s; (b) text8's word2vec vectors (phase
   7's config, one epoch through B4: its launches join the kernels line),
   KMeansClustering at the defaults (k=8, 100 iterations) on the card,
   its labels equal and centroids within 1e-4 of Lloyd on the CPU from
   the same initial centroids; exact Tsne of every word at TsneConfig's
   defaults (float64): the KL at the end below iteration 100's, the P on
   the host and the device loop timed, 20 iterations from the same y0
   within 1e-3 relative of the CPU's; render_embedding_html's page;
   BarnesHutTsne of the 300 most frequent words for 30 iterations (below
   full width: its negative forces are host Python), card against CPU
   within 1e-5; (c) default_tagger's tags of 500 text8 windows, a
   Word2VecDataSetIterator over (b)'s vectors (window 5: 500 inputs)
   into a softmax MultiLayerNetwork, viterbi.decode_batch of the 100
   held-out windows' emissions with transitions_from_labels: paths equal
   to the CPU's decode, tag accuracy above the majority tag's share; (d)
   NewsGroupsLoader(tfidf=True, n_docs=4000) feeding a softmax
   MultiLayerNetwork on the card: the TF-IDF tensor equal to its numpy
   values, held-out accuracy >= 0.9.  Four spawned workers parse and tag
   and run the CPU sides of the checks (one of them Barnes-Hut on the
   card) while this process drives the card.
26. The examples: each of the seven under deeplearning4j_tpu_torch/
   examples runs on the card as a user runs it (python -m
   deeplearning4j_tpu_torch.examples.<name> in a subprocess, all seven
   at once, the 8-rank parallelism_axes (gloo ranks sharing the card)
   beside the six others, a deadline each).  Checks: exit code 0 and
   the lines each prints: LeNet's test accuracy >= 0.90, word2vec's
   three nearest words to "sea" in the vocabulary (both pair modes),
   GloVe's similarities finite, every LM and BERT loss finite and the
   last below the first where a run prints several, every
   parallelism-axes loss finite, the chaotic word counts identical to
   the clean ones, the streaming accuracies >= 0.85; text_generation,
   data_parallel and parallelism_axes launched B1, B2 and B3 and
   word_embeddings B4 and B5 (each example's "kernel launches:" line;
   the counts join the kernels line).  Prints each example's wall
   seconds beside the card's name and power limit.

Each phase prints its seconds on a line of its own when it ends
("phase N: S s"), and the script prints every phase's seconds and its
own before the kernels line.

Phases 4-10 and 14-18 run through the compile engine as a user's calls
do: every serving dispatch, training step, decode and prefill dispatch
and embedding chunk is a CUDA graph replay after its signature's
capture, and the kernel wrappers' launch counts are booked once per
replay.

Phase 3 also holds the backward kernels B2 (dK/dV) and B3 (dQ) against
their plain twins on the same 17 cases (bf16 within 3e-2 of the case's
largest |grad|, fp32 5e-4), and times them (profiler, per kernel) beside
their twins, their bound and the backward of
F.scaled_dot_product_attention.  The twins skip B1's causal tiles
(causal_tile=CAUSAL_TILE), so every row is held, a causal row whose every
key is masked included; each case prints the route the kernels took
(wgmma, mma.sync or cuda-cores).  Phase 2 fails if a Hopper (wgmma)
kernel spills registers, and prints the Hopper kernels' dynamic shared
memory.  Phase 3c holds B4 (word2vec chunk, which updates its tables in
place, so each call gets copies) against its plain twin evaluated in
fp64 on 11 cases (the JAX test shape, text8 and Zipf shapes, padded
pairs, negative == target, D=50, 300 and 600, the last through the
kernel's wide path) and B5 (GloVe chunk) in its accumulator mode against
its twin on 5 (D=600 the wide path), and B5's in-place chunk step
against glove_chunk_step_plain on 4 of them (text8, Zipf, 25% masked,
D=600), with tolerances from each chunk's hit counts (see U32; B5's per
entry, carried through the AdaGrad step for the step cases).  It times
both at the text8 and Zipf shapes: B4's call as the device time summed
over its phases (profiler) and as a whole call (CUDA events), B5's chunk
step beside the old composition (accumulator mode, two apply_chunk, the
cat and the slice writes) in the same run, each beside its twin and
bound; no PyTorch call computes either function, so they have no
library time.

Prints one {"kernels": [...]} line and, last, {"ok": true, "device": ...}.
Exits non-zero, printing no result, when CUDA is absent or any phase
fails.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import math
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

#: published dense peaks of an H100 SXM at its 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

TOL = {"bfloat16": 3e-2, "float32": 2e-5}
LOGITS_TOL = 5e-2          # bf16 logits, as the CPU parity tests
MIN_ARGMAX_AGREE = 0.99


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def time_ms(torch, fn, iters: int = 50, warmup: int = 3) -> float:
    """Device ms per call, CUDA events around ``iters`` calls.  A sleep
    kernel holds the stream first, so the host enqueues the calls ahead
    and the events time the device, not the Python wrapper."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def flash_bound(B, NH, Tq, Tk, D, itemsize, causal):
    """(bound_ms, bound_by) of a bf16 call: the larger of the FLOPs over
    the bf16 peak and the bytes (q, k, v, o, bias, lse once each) over
    the memory rate."""
    flops = 4.0 * B * NH * Tq * Tk * D * (0.5 if causal else 1.0)
    nbytes = (itemsize * B * NH * D * (2 * Tq + 2 * Tk)
              + 4 * B * Tk + 4 * B * NH * Tq)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def ptxas_summary(log: str):
    """One entry per kernel of an ``nvcc -Xptxas -v`` report: (its name
    and template argument, a line with its registers, static shared
    memory and spill stores and loads, spilled bytes)."""
    import re

    out, kernel, spill = [], None, ""
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            mangled = kernel = entry.group(1)
            spill = ""
            # <length><identifier> of the kernel, then its template int;
            # the digits before it may end a hex namespace hash
            for m in re.finditer(r"(\d+)((?:flash|w2v|glove)_\w+)",
                                   mangled):
                digits, rest = m.group(1), m.group(2)
                for i in range(len(digits)):
                    ident = rest[:int(digits[i:])]
                    if ident.endswith("_kernel"):
                        arg = re.match(r"ILi(\d+)E", rest[len(ident):])
                        kernel = ident + (f"<{arg.group(1)}>" if arg
                                          else "")
                        break
        elif "spill stores" in line:
            spill = line.strip()
        elif "registers" in line and kernel is not None:
            regs = re.search(r"Used (\d+) registers", line)
            smem = re.search(r"(\d+) bytes smem", line)
            spilled = sum(int(n) for n in re.findall(
                r"(\d+) bytes spill (?:stores|loads)", spill))
            out.append((kernel, f"{kernel}: {regs.group(1) if regs else '?'} "
                        f"registers, {smem.group(1) if smem else 0} bytes "
                        f"static smem; {spill}", spilled))
            kernel = None
    return out


# ---------------------------------------------------------------------------
# phase 3: the flash kernel against its plain twin
# ---------------------------------------------------------------------------

KERNEL_CASES = [
    # name, B, NH, Tq, Tk, D, dtype, causal, key lengths (None = all live)
    ("bert-base T=128", 8, 12, 128, 128, 64, "bfloat16", False, None),
    ("bert-base T=512", 8, 12, 512, 512, 64, "bfloat16", False, None),
    ("padded keys", 8, 12, 128, 128, 64, "bfloat16", False,
     [128, 100, 64, 1, 77, 128, 5, 120]),
    ("causal", 4, 12, 256, 256, 64, "bfloat16", True, None),
    ("causal ragged, padded", 2, 4, 200, 200, 64, "bfloat16", True,
     [200, 150]),
    ("ragged T=200", 4, 12, 200, 200, 64, "bfloat16", False,
     [200, 180, 64, 3]),
    ("Tq != Tk", 2, 4, 100, 300, 64, "bfloat16", False, [300, 211]),
    ("fully masked row", 2, 4, 128, 128, 64, "bfloat16", False, [0, 100]),
    ("fp32", 4, 12, 128, 128, 64, "float32", False, [128, 90, 33, 128]),
    ("fp32 causal D=128", 2, 4, 160, 160, 128, "float32", True, None),
    ("fp32 D=256", 1, 2, 96, 96, 256, "float32", False, [70]),
    ("D=128", 4, 8, 256, 256, 128, "bfloat16", False, [256, 200, 7, 256]),
    ("D=256", 1, 4, 130, 130, 256, "bfloat16", False, [130]),
    ("D=40", 2, 3, 70, 70, 40, "bfloat16", True, [70, 41]),
    # one sequence's keys all masked under causal masking: its rows see
    # only the -1e5 scores of the 64-key tiles B1 walked, which the
    # tile-exact twins (causal_tile=CAUSAL_TILE) follow
    ("causal, one sequence fully masked", 2, 12, 256, 256, 64, "bfloat16",
     True, [0, 256]),
    ("D=128 causal", 2, 4, 256, 256, 128, "bfloat16", True, [256, 190]),
    ("Tq != Tk D=128", 2, 4, 300, 100, 128, "bfloat16", False, [100, 57]),
]

#: forward-only cases at the edges of the wgmma B1: serving's smallest
#: bucket (12 CTAs); an odd count of 64-row tiles, so the last 128-row
#: CTA's second warpgroup has no rows, with one causal sequence fully
#: masked; and D=128 causal at GPT-2 small's length
FWD_CASES = KERNEL_CASES + [
    ("serving B=1 T=128", 1, 12, 128, 128, 64, "bfloat16", False, [128]),
    ("causal T=192, one sequence fully masked", 2, 12, 192, 192, 64,
     "bfloat16", True, [0, 192]),
    ("D=128 causal T=1024", 2, 4, 1024, 1024, 128, "bfloat16", True, None),
]


def kernel_phase(torch, fa, cases=FWD_CASES):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    worst = 0.0
    for name, B, NH, Tq, Tk, D, dt, causal, lens in cases:
        dtype = getattr(torch, dt)

        def rand(T):
            return torch.randn((B, T, NH, D), generator=gen, device="cuda",
                               dtype=torch.float32).to(dtype)

        q, k, v = rand(Tq), rand(Tk), rand(Tk)
        mask = None
        if lens is not None:
            mask = (torch.arange(Tk, device="cuda")[None, :]
                    < torch.tensor(lens, device="cuda")[:, None]).float()
        bias = None if mask is None else (1.0 - mask) * fa.MASK_VAL

        def bhtd(x):
            return x.permute(0, 2, 1, 3).reshape(B * NH, x.shape[1], D) \
                .contiguous()

        q4, k4, v4 = bhtd(q), bhtd(k), bhtd(v)
        o, lse = fa.flash_attention_fwd_cuda(q4, k4, v4, bias, causal)
        o_h = fa.flash_attention(q, k, v, mask, causal)   # [B, T, NH, D]
        o_ref, lse_ref = fa.flash_attention_fwd_plain(
            q4, k4, v4, bias, causal, causal_tile=fa.CAUSAL_TILE)
        torch.cuda.synchronize()
        tol = TOL[dt]
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_h = (bhtd(o_h).float() - o_ref.float()).abs().max().item()
        err_lse = (lse - lse_ref).abs().max().item()
        ok = (torch.allclose(o.float(), o_ref.float(), rtol=tol, atol=tol)
              and torch.allclose(bhtd(o_h).float(), o_ref.float(),
                                 rtol=tol, atol=tol)
              and torch.allclose(lse, lse_ref, rtol=tol, atol=tol)
              and bool(torch.isfinite(o.float()).all()))
        print(f"  kernel case {name!r} [{fa.fwd_route(dtype, D)}]: B={B} "
              f"NH={NH} Tq={Tq} Tk={Tk} "
              f"D={D} {dt} causal={causal}: max|o-o_plain|={err_o:.3e} "
              f"([B,T,NH,D] path {err_h:.3e}) max|lse-lse_plain|="
              f"{err_lse:.3e} tol={tol:g} {'ok' if ok else 'FAIL'}")
        check(ok, f"flash kernel disagrees with its plain twin: {name}")
        worst = max(worst, err_o, err_h)
    return worst


def time_flash(torch, F, fa, B, T, NH=12, D=64, causal=False):
    """Kernel, plain twin and SDPA, bf16: at a serving shape with the
    all-live mask bias of the serving path, or causal with no bias, as
    GPT's training path calls it."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)

    def rand():
        return torch.randn((B * NH, T, D), generator=gen, device="cuda",
                           dtype=torch.float32).to(torch.bfloat16)

    q4, k4, v4 = rand(), rand(), rand()
    bias = None if causal else torch.zeros((B, T), device="cuda",
                                           dtype=torch.float32)
    q_s, k_s, v_s = (x.view(B, NH, T, D) for x in (q4, k4, v4))
    with torch.inference_mode():
        ms = time_ms(torch, lambda: fa.flash_attention_fwd_cuda(
            q4, k4, v4, bias, causal))
        plain_ms = time_ms(torch, lambda: fa.flash_attention_fwd_plain(
            q4, k4, v4, bias, causal), iters=10)
        lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q_s, k_s, v_s, is_causal=causal))
    bound_ms, bound_by = flash_bound(B, NH, T, T, D, 2, causal)
    flops = 4.0 * B * NH * T * T * D * (0.5 if causal else 1.0)
    print(f"  flash fwd B={B} NH={NH} T={T} D={D} bf16 causal={causal} "
          f"[{fa.fwd_route(torch.bfloat16, D)}]: "
          f"kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
          f"{ms / lib_ms:.2f}x sdpa), plain "
          f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {bound_ms:.4f} "
          f"ms ({bound_by}) [events]")
    return ms, plain_ms, lib_ms, bound_ms, bound_by


# ---------------------------------------------------------------------------
# phase 3b: the backward kernels against their plain twins
# ---------------------------------------------------------------------------

BWD_TOL = {"bfloat16": 3e-2, "float32": 5e-4}


def bwd_error(torch, got, ref, dt: str):
    """(max |got - ref|, ok): bf16 within 3e-2 of the case's largest
    |grad|, fp32 within 5e-4 (tests/test_pallas_attention.py:55)."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs().max().item()
    tol = BWD_TOL[dt]
    if dt == "bfloat16":
        ok = err <= tol * max(ref.abs().max().item(), 1e-30)
    else:
        ok = bool(torch.allclose(got, ref, rtol=tol, atol=tol))
    return err, ok and bool(got.isfinite().all())


def kernel_bwd_phase(torch, fa, cases=KERNEL_CASES):
    """B2 and B3 on the kernel cases, against the tile-exact plain twins
    (causal_tile=CAUSAL_TILE) fed the same o and lse (B1's), through the
    [BH, T, D] entry point and through autograd on [B, T, NH, D]; each
    case prints the route the C entry points took."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4321)
    worst = {"dkv": 0.0, "dq": 0.0}
    for name, B, NH, Tq, Tk, D, dt, causal, lens in cases:
        dtype = getattr(torch, dt)

        def rand(T):
            return torch.randn((B, T, NH, D), generator=gen, device="cuda",
                               dtype=torch.float32).to(dtype)

        q, k, v, do = rand(Tq), rand(Tk), rand(Tk), rand(Tq)
        mask = None
        if lens is not None:
            mask = (torch.arange(Tk, device="cuda")[None, :]
                    < torch.tensor(lens, device="cuda")[:, None]).float()
        bias = None if mask is None else (1.0 - mask) * fa.MASK_VAL

        def bhtd(x):
            return x.permute(0, 2, 1, 3).reshape(B * NH, x.shape[1], D) \
                .contiguous()

        q4, k4, v4, do4 = bhtd(q), bhtd(k), bhtd(v), bhtd(do)
        o, lse = fa.flash_attention_fwd_cuda(q4, k4, v4, bias, causal)
        dq, dk, dv = fa.flash_attention_bwd_cuda(q4, k4, v4, bias, o, lse,
                                                 do4, causal)
        qh, kh, vh = (x.clone().requires_grad_(True) for x in (q, k, v))
        oh = fa.flash_attention(qh, kh, vh, mask, causal)
        gh = torch.autograd.grad(oh, (qh, kh, vh), do)
        dk_ref, dv_ref = fa.flash_attention_bwd_dkv_plain(
            q4, k4, v4, bias, o, lse, do4, causal,
            causal_tile=fa.CAUSAL_TILE)
        dq_ref = fa.flash_attention_bwd_dq_plain(
            q4, k4, v4, bias, o, lse, do4, causal,
            causal_tile=fa.CAUSAL_TILE)
        torch.cuda.synchronize()
        errs, oks = {}, []
        for label, got, ref in (("dq", dq, dq_ref), ("dk", dk, dk_ref),
                                ("dv", dv, dv_ref),
                                ("dq[BTHD]", bhtd(gh[0]), dq_ref),
                                ("dk[BTHD]", bhtd(gh[1]), dk_ref),
                                ("dv[BTHD]", bhtd(gh[2]), dv_ref)):
            errs[label], ok = bwd_error(torch, got, ref, dt)
            oks.append(ok)
        ok = all(oks)
        print(f"  backward case {name!r} [{fa.bwd_route(dtype, D)}]: "
              + " ".join(f"{k}={v:.3e}" for k, v in errs.items())
              + f" (max|ref| dq {dq_ref.float().abs().max().item():.3e}, "
              f"dk {dk_ref.float().abs().max().item():.3e}, dv "
              f"{dv_ref.float().abs().max().item():.3e}) tol="
              f"{BWD_TOL[dt]:g}{' x max|ref|' if dt == 'bfloat16' else ''} "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"flash backward kernels disagree with their plain twins: "
                  f"{name}")
        worst["dkv"] = max(worst["dkv"], errs["dk"], errs["dv"],
                           errs["dk[BTHD]"], errs["dv[BTHD]"])
        worst["dq"] = max(worst["dq"], errs["dq"], errs["dq[BTHD]"])
    return worst


def bwd_bound(B, NH, Tq, Tk, D, itemsize, causal, kernel):
    """(bound_ms, bound_by) of B2 ("dkv") or B3 ("dq"): the larger of
    its FLOPs (8 or 6 * BH*Tq*Tk*D, halved when causal) over the bf16
    peak and its bytes (q, k, v, dO read and its gradients written once,
    lse, delta and the bias) over the memory rate."""
    BH = B * NH
    flops = ((8.0 if kernel == "dkv" else 6.0) * BH * Tq * Tk * D
             * (0.5 if causal else 1.0))
    grads = 2 * Tk if kernel == "dkv" else Tq
    nbytes = (itemsize * BH * D * (2 * Tq + 2 * Tk + grads)
              + 4 * 2 * BH * Tq + 4 * B * Tk)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def profile_kernel_ms(torch, fn, names, iters: int = 20):
    """Mean device ms per call of each kernel whose name contains one of
    ``names``, from torch.profiler over ``iters`` calls of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {n: 0.0 for n in names}
    for e in prof.key_averages():
        for n in names:
            if n in e.key:
                out[n] += e.self_device_time_total / 1e3 / iters
    return out


def profile_call_ms(torch, fn, iters: int = 20):
    """(device ms per call summed over every kernel and memset a call of
    ``fn`` launches, {name: ms per call}), torch.profiler over ``iters``
    calls after 3 warm-up calls.  A profile that reports no device time
    (the profiler on the card has returned an empty trace now and then)
    is taken again, up to three times."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        by = {e.key: e.self_device_time_total / 1e3 / iters
              for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0}
        if by:
            break
    return sum(by.values()), by


def phases(by, marks):
    """One line of a call's device ms by phase: each mark's kernels."""
    return ", ".join(f"{m} {sum(ms for k, ms in by.items() if m in k):.4f}"
                     for m in marks)


def time_flash_bwd(torch, F, fa, B, T, NH=12, D=64, causal=False):
    """B2 and B3 (device time of each, from the profiler), the whole
    backward call (CUDA events), their plain twins, and the backward of
    F.scaled_dot_product_attention (a yardstick the port never calls),
    bf16 with an all-live mask bias."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)

    def rand():
        return torch.randn((B * NH, T, D), generator=gen, device="cuda",
                           dtype=torch.float32).to(torch.bfloat16)

    q4, k4, v4, do4 = rand(), rand(), rand(), rand()
    bias = torch.zeros((B, T), device="cuda", dtype=torch.float32)
    o, lse = fa.flash_attention_fwd_cuda(q4, k4, v4, bias, causal)
    args = (q4, k4, v4, bias, o, lse, do4, causal)
    prof = profile_kernel_ms(torch, lambda: fa.flash_attention_bwd_cuda(
        *args), ("flash_bwd_dkv", "flash_bwd_dq"))
    call_ms = time_ms(torch, lambda: fa.flash_attention_bwd_cuda(*args))
    dkv_plain = time_ms(torch, lambda: fa.flash_attention_bwd_dkv_plain(
        *args), iters=10)
    dq_plain = time_ms(torch, lambda: fa.flash_attention_bwd_dq_plain(
        *args), iters=10)
    qs, ks, vs = (x.view(B, NH, T, D).detach().requires_grad_(True)
                  for x in (q4, k4, v4))
    out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)
    dos = do4.view(B, NH, T, D)
    lib_ms = time_ms(torch, lambda: torch.autograd.grad(
        out, (qs, ks, vs), dos, retain_graph=True))
    rows = {}
    for kernel, ms, plain_ms in (("dkv", prof["flash_bwd_dkv"], dkv_plain),
                                 ("dq", prof["flash_bwd_dq"], dq_plain)):
        bound_ms, bound_by = bwd_bound(B, NH, T, T, D, 2, causal, kernel)
        rows[kernel] = (ms, plain_ms, lib_ms, bound_ms, bound_by)
    # achieved rates on the FLOPs each kernel runs (B2 four products, B3
    # three, halved when causal); SDPA's backward on its five
    half = 0.5 if causal else 1.0
    fl = {"dkv": 8.0 * B * NH * T * T * D * half,
          "dq": 6.0 * B * NH * T * T * D * half}
    pair_ms = rows["dkv"][0] + rows["dq"][0]
    print(f"  flash bwd B={B} NH={NH} T={T} D={D} bf16 causal={causal} "
          f"[{fa.bwd_route(torch.bfloat16, D)}]: B2 {rows['dkv'][0]:.4f} ms "
          f"(bound {rows['dkv'][3]:.4f}, {rows['dkv'][4]}; "
          f"{fl['dkv'] / rows['dkv'][0] / 1e9:.1f} TFLOP/s), B3 "
          f"{rows['dq'][0]:.4f} ms (bound {rows['dq'][3]:.4f}, "
          f"{rows['dq'][4]}; {fl['dq'] / rows['dq'][0] / 1e9:.1f} TFLOP/s), "
          f"B2 + B3 {pair_ms:.4f} ms ({(fl['dkv'] + fl['dq']) / pair_ms / 1e9:.1f}"
          f" TFLOP/s, {pair_ms / lib_ms:.2f}x sdpa's backward) [profiler]; "
          f"whole backward call {call_ms:.4f} ms [events]; plain B2 "
          f"{dkv_plain:.4f} ms, plain B3 {dq_plain:.4f} ms; sdpa backward "
          f"{lib_ms:.4f} ms ({10.0 * B * NH * T * T * D * half / lib_ms / 1e9:.1f}"
          f" TFLOP/s) [events]")
    check(rows["dkv"][0] > 0 and rows["dq"][0] > 0,
          "the profiler saw no device time for B2/B3")
    return rows


# ---------------------------------------------------------------------------
# phase 4: BERT-base fill-mask serving
# ---------------------------------------------------------------------------

def compare(got: np.ndarray, ref, what: str):
    """Logits against a reference forward: (max |diff|, argmax matches,
    positions).  Fails beyond the bf16 logits tolerance."""
    ref = ref.float().cpu().numpy()
    check(got.shape == ref.shape, f"{what}: shape {got.shape} != {ref.shape}")
    err = float(np.abs(got - ref).max())
    check(np.allclose(got, ref, rtol=LOGITS_TOL, atol=LOGITS_TOL),
          f"{what}: logits differ by up to {err} (tolerance {LOGITS_TOL})")
    same = int((got.argmax(-1) == ref.argmax(-1)).sum())
    return err, same, got.shape[0] * got.shape[1]


def check_agreement(rows, what: str) -> float:
    """Aggregate (err, matches, positions) rows; fail under 99% argmax."""
    err = max(r[0] for r in rows)
    same, total = sum(r[1] for r in rows), sum(r[2] for r in rows)
    frac = same / total
    print(f"  {what}: max|diff|={err:.3e} (tolerance {LOGITS_TOL}), "
          f"fill-mask argmax agreement {same}/{total} = {frac:.4f} "
          f"(need >= {MIN_ARGMAX_AGREE})")
    check(frac >= MIN_ARGMAX_AGREE, f"{what}: argmax agreement {frac}")
    return err


class PlainAgreement:
    """The served (kernel-path) logits against the same forward with the
    plain attention (bf16) and with fp32 compute, over many requests.

    With random weights about 1% of positions have a top-1/top-2 logit
    gap below bf16's resolution, and any two bf16 forwards — with or
    without the kernel — disagree on about that many argmaxes.  So the
    99% argmax bar is held on the positions the fp32 forward resolves
    (gap >= 2^-8 of its largest logit), and over all positions the
    kernel path must agree with fp32 as well as the plain path does."""

    TIE = 2.0 ** -8

    def __init__(self, what: str):
        self.what = what
        self.err = 0.0
        self.n = self.same = self.n_res = self.same_res = 0
        self.kernel_fp32 = self.plain_fp32 = 0

    def add(self, got: np.ndarray, plain, fp32) -> None:
        plain = plain.float().cpu().numpy()
        fp32 = fp32.float().cpu().numpy()
        check(got.shape == plain.shape == fp32.shape,
              f"{self.what}: shapes {got.shape} {plain.shape} {fp32.shape}")
        err = float(np.abs(got - plain).max())
        check(np.allclose(got, plain, rtol=LOGITS_TOL, atol=LOGITS_TOL),
              f"{self.what}: logits differ from the plain-attention "
              f"forward by up to {err} (tolerance {LOGITS_TOL})")
        self.err = max(self.err, err)
        a_k, a_p, a_32 = got.argmax(-1), plain.argmax(-1), fp32.argmax(-1)
        top2 = np.partition(fp32, -2, axis=-1)[..., -2:]
        resolved = (top2[..., 1] - top2[..., 0]) >= \
            self.TIE * float(np.abs(fp32).max())
        self.n += a_k.size
        self.same += int((a_k == a_p).sum())
        self.n_res += int(resolved.sum())
        self.same_res += int((a_k == a_p)[resolved].sum())
        self.kernel_fp32 += int((a_k == a_32).sum())
        self.plain_fp32 += int((a_p == a_32).sum())

    def check(self) -> None:
        res = self.same_res / self.n_res
        k32, p32 = self.kernel_fp32 / self.n, self.plain_fp32 / self.n
        print(f"  {self.what}: max|diff| vs plain attention {self.err:.3e} "
              f"(tolerance {LOGITS_TOL}); fill-mask argmax agreement "
              f"{self.same}/{self.n} = {self.same / self.n:.4f} over all "
              f"positions, {self.same_res}/{self.n_res} = {res:.4f} over "
              f"the positions fp32 resolves (need >= {MIN_ARGMAX_AGREE}); "
              f"agreement with the fp32 forward: kernel path {k32:.4f}, "
              f"plain path {p32:.4f}")
        check(res >= MIN_ARGMAX_AGREE,
              f"{self.what}: resolved argmax agreement {res}")
        check(k32 >= p32 - 0.005,
              f"{self.what}: kernel path agrees with fp32 on {k32}, the "
              f"plain path on {p32}")


def serving_phase(torch, fa):
    from deeplearning4j_tpu_torch.models import bert
    from deeplearning4j_tpu_torch.models import transformer as tfm
    from deeplearning4j_tpu_torch.runtime.metrics import serving_metrics
    from deeplearning4j_tpu_torch.serving.batcher import DynamicBatcher
    from deeplearning4j_tpu_torch.serving.engine import InferenceEngine

    cfg = bert.bert_base()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = bert.init_params(gen, cfg, device="cuda")
    apply_fn = bert.make_serving_apply(cfg)
    eng = InferenceEngine(apply_fn, params, max_batch_size=32)
    w = eng.warmup(input_shape=(128,), dtype=np.int32)
    print(f"  warmup: {w['buckets']} buckets in {w['warmup_ms']:.1f} ms")

    rng = np.random.default_rng(0)

    def request(rows, T):
        ids = rng.integers(1000, cfg.vocab_size, (rows, T)).astype(np.int32)
        ids[rng.random((rows, T)) < 0.15] = 103       # [MASK]
        return ids

    reqs = [request(int(rng.integers(1, 9)), 128) for _ in range(24)]
    long_req = request(4, 512)
    eng512 = InferenceEngine(apply_fn, params, max_batch_size=4)
    eng512.warmup(input_shape=(512,), dtype=np.int32)

    # -- the main path, counted ------------------------------------------
    results = [None] * len(reqs)
    errors = []
    batcher = DynamicBatcher(eng, max_batch_size=32, max_delay_ms=5.0)

    def client(ids):
        try:
            futs = [(i, batcher.submit(reqs[i])) for i in ids]
            for i, f in futs:
                results[i] = f.result(timeout=300)
        except Exception as e:      # surfaced below, after the join
            errors.append(e)

    n_clients = 4
    threads = [threading.Thread(target=client,
                                args=(range(c, len(reqs), n_clients),))
               for c in range(n_clients)]
    fa.reset_launches()
    serving_metrics.reset()
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    batcher.close()
    check(not any(t.is_alive() for t in threads), "client threads hung")
    check(not errors, f"client errors: {errors!r}")
    snap = serving_metrics.snapshot()
    launches_batched = fa.launches
    out512 = eng512.infer(long_req, sync=True).float().cpu().numpy()
    launches_total = fa.launches

    tokens = sum(r.size for r in reqs)
    print(f"  served {len(reqs)} requests ({tokens} tokens) from "
          f"{n_clients} client threads in {wall * 1e3:.1f} ms: "
          f"{tokens / wall:.1f} tokens/s; {snap['dispatches']} dispatches, "
          f"{snap['batches_formed']} batches, padding waste "
          f"{snap['padding_waste_ratio']:.3f}; request latency p50 "
          f"{snap['latency_p50_ms']:.2f} ms p99 "
          f"{snap['latency_p99_ms']:.2f} ms ({snap['latency_samples']} "
          f"samples)")
    print(f"  flash launches: {launches_batched} over "
          f"{snap['dispatches']} batched dispatches, "
          f"{launches_total - launches_batched} for the T=512 dispatch "
          f"({cfg.n_layers} layers)")
    check(snap["dispatches"] > 0, "no dispatch ran")
    check(launches_batched == cfg.n_layers * snap["dispatches"],
          "flash kernel launches != layers x batched dispatches")
    check(launches_total - launches_batched == cfg.n_layers,
          "flash kernel launches != layers for the T=512 dispatch")

    # -- correctness of what came out ------------------------------------
    vocab = cfg.vocab_size
    plain_apply = bert.make_serving_apply(cfg, attn_fn=tfm.attention)
    fp32_apply = bert.make_serving_apply(
        dataclasses.replace(cfg, compute_dtype="float32"),
        attn_fn=tfm.attention)
    own = []
    plain = PlainAgreement("T=128 results")
    plain512 = PlainAgreement("T=512 result")
    with torch.inference_mode():
        for i, (x, got) in enumerate(zip(reqs, results)):
            check(got is not None and got.shape == (x.shape[0], 128, vocab),
                  f"request {i}: bad result shape "
                  f"{None if got is None else got.shape}")
            check(bool(np.isfinite(got).all()), f"request {i}: non-finite")
            xt = torch.from_numpy(x).cuda()
            own.append(compare(got, apply_fn(params, xt),
                               f"request {i} vs its unpadded forward"))
            plain.add(got, plain_apply(params, xt), fp32_apply(params, xt))
        check(bool(np.isfinite(out512).all()), "T=512 logits non-finite")
        xt = torch.from_numpy(long_req).cuda()
        plain512.add(out512, plain_apply(params, xt), fp32_apply(params, xt))
    check_agreement(own, "batched results vs each request's unpadded "
                         "forward (own rows)")
    plain.check()
    plain512.check()

    # -- where a full dispatch's time goes ---------------------------------
    x32 = request(32, 128)
    fwd, d2h = [], []
    for _ in range(7):
        t0 = time.perf_counter()
        out = eng.infer(x32, sync=True)
        t1 = time.perf_counter()
        out.cpu().numpy()
        d2h.append(time.perf_counter() - t1)
        fwd.append(t1 - t0)
    print(f"  one 32-row T=128 dispatch: forward {np.median(fwd) * 1e3:.2f} "
          f"ms (host clock, synchronized), logits to host "
          f"{np.median(d2h) * 1e3:.2f} ms ({out.numel() * 4 / 1e6:.0f} MB), "
          f"median of 7")
    profile_dispatch(torch, lambda: eng.infer(x32, sync=True))
    return launches_total


def profile_dispatch(torch, run) -> None:
    """Device time of one dispatch by kernel, from torch.profiler: the
    busy share of the dispatch's wall time and the largest kernels."""
    from torch.profiler import ProfilerActivity, profile

    run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy_us = sum(r[1] for r in rows)
    if not rows:
        print("  profiler: no device time reported (busy share not "
              "measured)")
        return
    print(f"  profiler, one 32-row T=128 dispatch: device busy "
          f"{busy_us / 1e3:.2f} ms of {wall_us / 1e3:.2f} ms wall "
          f"({busy_us / wall_us:.1%})")
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:8]:
        print(f"    {us / 1e3:8.3f} ms  {count:4d}x  {key[:90]}")


# ---------------------------------------------------------------------------
# phases 5 and 6: BERT-base MLM and GPT-2 small training
# ---------------------------------------------------------------------------

GRAD_TOL_BF16 = 3e-2       # kernel path vs plain attention, global rel. L2
GRAD_TOL_FP32 = 1e-4
WARMUP_STEPS = 2
TIMED_STEPS = 10


def launches_per_step(cfg):
    """B1/B2/B3 launches of one training step: each layer's backward runs
    B2 and B3 once; its forward runs B1 once, and again in the backward
    when cfg.remat recomputes the block (as jax.checkpoint does)."""
    L = cfg.n_layers
    return {"launches": (2 if cfg.remat else 1) * L, "launches_dkv": L,
            "launches_dq": L}


def bert_train_flops(cfg, batch: int, seq: int) -> float:
    """Analytic matmul FLOPs for one BERT MLM training step (fwd*3):
    per layer 8BTh² (qkv+out) + 4BTh·ffn (mlp) + 4BT²h (scores+values),
    plus the vocab logits matmul 2BThV (bench.py:143)."""
    L, h, f, V = cfg.n_layers, cfg.hidden, cfg.ffn_dim, cfg.vocab_size
    per_layer = (8 * batch * seq * h * h + 4 * batch * seq * h * f
                 + 4 * batch * seq * seq * h)
    fwd = L * per_layer + 2 * batch * seq * h * V
    return 3.0 * fwd


def gpt_train_flops(cfg, batch: int, seq: int) -> float:
    """Analytic matmul FLOPs for one causal-LM training step (fwd*3),
    the dense score matrix counted full (bench.py:265)."""
    L, h, f, V = cfg.n_layers, cfg.hidden, cfg.ffn_dim, cfg.vocab_size
    per_layer = (8 * batch * seq * h * h + 4 * batch * seq * h * f
                 + 4 * batch * seq * seq * h)
    return 3.0 * (L * per_layer + 2 * batch * seq * h * V)


def grad_agreement(updaters, got, ref):
    """(global relative L2 error, the leaf with the largest error, that
    leaf's own relative L2 error).  The largest error, not the largest
    relative one: a leaf whose true gradient is 0 up to rounding (the
    key bias: softmax ignores a shift shared by a row's scores) has a
    meaningless relative error."""
    paths = []

    def walk(tree, prefix):
        for key, val in tree.items():
            if isinstance(val, dict):
                walk(val, prefix + key + "/")
            else:
                paths.append(prefix + key)
    walk(ref, "")
    num = den = 0.0
    worst = ("", -1.0, 0.0)
    for path, g, r in zip(paths, updaters.tree_leaves(got),
                          updaters.tree_leaves(ref)):
        d = float((g.float() - r.float()).norm()) ** 2
        n = float(r.float().norm()) ** 2
        num, den = num + d, den + n
        if d > worst[1]:
            worst = (path, d, (d / n) ** 0.5 if n > 0 else float("inf"))
    return (num / den) ** 0.5, worst[0], worst[2]


GEMM_MARKS = ("gemm", "Gemm", "GEMM", "nvjet", "cutlass", "xmma", "cublas")


def device_ms_by_kernel(torch, run):
    """{kernel name: device ms} of one call of ``run``, torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0}


def gemm_ms(by_kernel) -> float:
    return sum(ms for k, ms in by_kernel.items()
               if any(m in k for m in GEMM_MARKS))


def profile_step(torch, tfm, updaters, what, step_fn, state, batch, gen,
                 forward_loss, optimizer, step_ms: float) -> None:
    """Where one training step's device time goes: the whole step, the
    forward alone (its products), and the optimizer alone, each from
    torch.profiler; backward products = the step's minus the forward's.
    The busy share is the step's device time over ``step_ms``, the
    unprofiled median step (the profiler slows the host)."""
    step_k = device_ms_by_kernel(torch, lambda: step_fn(state, batch, gen))
    with torch.no_grad():
        fwd_k = device_ms_by_kernel(torch, lambda: forward_loss(
            state.params))
    _, grads = tfm.value_and_grad(forward_loss, state.params)
    opt_k = device_ms_by_kernel(torch, lambda: updaters.apply_updates(
        state.params, optimizer.update(grads, state.opt_state,
                                       state.params)[0]))
    if not step_k:
        print(f"  {what} profile: no device time reported (not measured)")
        return
    busy = sum(step_k.values())

    def named(mark):
        return sum(ms for k, ms in step_k.items() if mark in k)

    b1, b2, b3 = (named("flash_fwd"), named("flash_bwd_dkv"),
                  named("flash_bwd_dq"))
    g_all, g_fwd = gemm_ms(step_k), gemm_ms(fwd_k)
    opt = sum(opt_k.values())
    other = busy - b1 - b2 - b3 - g_all - opt
    print(f"  {what} profile of one step: device busy {busy:.2f} ms = "
          f"{busy / step_ms:.1%} of the median step; B1 {b1:.3f} ms "
          f"({b1 / busy:.1%}), B2 {b2:.3f} ms ({b2 / busy:.1%}), B3 "
          f"{b3:.3f} ms ({b3 / busy:.1%}); products {g_all:.3f} ms "
          f"({g_all / busy:.1%}): forward {g_fwd:.3f} ms, backward "
          f"{g_all - g_fwd:.3f} ms ({(g_all - g_fwd) / busy:.1%}); "
          f"optimizer {opt:.3f} ms ({opt / busy:.1%}, profiled alone); "
          f"the rest {other:.3f} ms ({other / busy:.1%})")
    vec_add, add, fill = fp32_add_fill_ms(step_k)
    print(f"  {what} profile of one step: fp32 add {vec_add:.3f} ms "
          f"(vectorized CUDAFunctor_add<float>; every fp32 add kernel "
          f"{add:.3f} ms), fills {fill:.3f} ms")
    for key, ms in sorted(step_k.items(), key=lambda kv: -kv[1])[:10]:
        print(f"    {ms:8.3f} ms  {key[:100]}")


def fp32_add_fill_ms(by_kernel):
    """(device ms of the vectorized fp32 add kernel, of every fp32 add
    kernel, of fills) in a profile.  Summing per-layer gradients of the
    stacked weights at full size ran in the first and the fills; one
    unbind per leaf removed that."""
    vec = sum(ms for k, ms in by_kernel.items()
              if "vectorized_elementwise_kernel" in k
              and "CUDAFunctor_add<float>" in k)
    add = sum(ms for k, ms in by_kernel.items()
              if "add" in k.lower() and "<float>" in k)
    fill = sum(ms for k, ms in by_kernel.items() if "FillFunctor" in k)
    return vec, add, fill


def remat_comparison(torch, mod, cfg, what, state, batch, gen, step_fn,
                     peak_on: float) -> None:
    """One step with cfg.remat off beside one with it on, in this run:
    peak memory and device time, and the fp32 adds and fills of each."""
    _, step_off = mod.make_train_step(dataclasses.replace(cfg, remat=False))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_off(state, batch, gen)
    torch.cuda.synchronize()
    peak_off = torch.cuda.max_memory_allocated() / 1e9
    on = device_ms_by_kernel(torch, lambda: step_fn(state, batch, gen))
    off = device_ms_by_kernel(torch, lambda: step_off(state, batch, gen))
    if not on or not off:
        print(f"  {what}: remat comparison: no device time reported")
        return
    (va_on, a_on, f_on), (va_off, a_off, f_off) = (fp32_add_fill_ms(on),
                                                   fp32_add_fill_ms(off))
    print(f"  {what}: remat on vs off, one step each: peak memory "
          f"{peak_on:.2f} vs {peak_off:.2f} GB; device busy "
          f"{sum(on.values()):.2f} vs {sum(off.values()):.2f} ms; fp32 add "
          f"(vectorized) {va_on:.3f} vs {va_off:.3f} ms, every fp32 add "
          f"{a_on:.3f} vs {a_off:.3f} ms, fills {f_on:.3f} vs {f_off:.3f} ms")


def train_phase(torch, fa, what, mod, cfg, batch, flops, loss_of):
    """Train ``cfg`` through ``mod.make_train_step`` defaults (flash
    attention, adamw) at full width: warm-up, then timed steps with the
    kernel launch counts read around them; then one step's gradients
    through the kernels against the plain attention (dropout 0), and a
    profile of one step.  ``loss_of(cfg, params, attn_fn)`` is the
    model's loss on ``batch``.  Returns the launch counts."""
    from deeplearning4j_tpu_torch.models import transformer as tfm
    from deeplearning4j_tpu_torch.ops import updaters

    init_fn, step_fn = mod.make_train_step(cfg)
    state = init_fn(torch.Generator(device="cuda").manual_seed(0))
    dropout_gen = torch.Generator(device="cuda").manual_seed(1)
    losses, step_s = [], []
    # the peak spans the warm-up: a captured step's workspace is taken
    # from its graph's pool at capture (the engine's warm-up runs execute
    # eagerly), and a replay allocates nothing
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(WARMUP_STEPS):
        state, loss = step_fn(state, batch, dropout_gen)
        losses.append(float(loss))
    torch.cuda.synchronize()

    # -- the main path, counted ------------------------------------------
    fa.reset_launches()
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        state, loss = step_fn(state, batch, dropout_gen)
        losses.append(float(loss))         # synchronizes
        step_s.append(time.perf_counter() - t0)
    counts = fa.launch_counts()

    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ms = float(np.median(step_s)) * 1e3
    tokens = (batch.token_ids if hasattr(batch, "token_ids")
              else batch).numel()
    print(f"  {what}: losses " + " ".join(f"{x:.4f}" for x in losses)
          + f" ({WARMUP_STEPS} warm-up, {TIMED_STEPS} timed)")
    print(f"  {what}: step {ms:.2f} ms (median of {TIMED_STEPS}, host clock, "
          f"synchronized; min {min(step_s) * 1e3:.2f}, max "
          f"{max(step_s) * 1e3:.2f}), {tokens / (ms / 1e3):.1f} tokens/s, "
          f"model FLOPs {flops / 1e12:.3f} TFLOP/step = "
          f"{flops / (ms / 1e3) / PEAK_BF16_FLOPS:.2%} of 989 TFLOP/s; "
          f"peak memory {peak_gb:.2f} GB (remat "
          f"{'on' if cfg.remat else 'off'})")
    print(f"  {what}: launches over the {TIMED_STEPS} timed steps: {counts} "
          f"({cfg.n_layers} layers)")
    check(all(np.isfinite(losses)), f"{what}: non-finite loss {losses}")
    check(losses[-1] < losses[WARMUP_STEPS],
          f"{what}: loss did not fall over the timed steps: {losses}")
    expect = launches_per_step(cfg)
    for name, n in counts.items():
        check(n == expect[name] * TIMED_STEPS,
              f"{what}: {name} = {n}, not {expect[name]} per step")

    # -- kernel-path gradients against the plain attention ----------------
    cfg0 = dataclasses.replace(cfg, dropout=0.0)
    kernel_attn = fa.make_attn_fn("auto")
    lk, gk = tfm.value_and_grad(
        lambda p: loss_of(cfg0, p, kernel_attn), state.params)
    lp, gp = tfm.value_and_grad(
        lambda p: loss_of(cfg0, p, tfm.attention), state.params)
    rel, leaf, leaf_rel = grad_agreement(updaters, gk, gp)
    del gp
    print(f"  {what}: dropout-0 step through the kernels vs the plain "
          f"attention: loss {float(lk):.6f} vs {float(lp):.6f}; gradients' "
          f"global relative L2 error {rel:.3e} (tolerance "
          f"{GRAD_TOL_BF16:g}); largest error in {leaf} (relative "
          f"{leaf_rel:.3e})")
    check(rel <= GRAD_TOL_BF16, f"{what}: kernel-path gradients differ "
                                f"from the plain path by {rel}")
    optimizer = updaters.adamw(1e-4, weight_decay=0.01)
    profile_step(torch, tfm, updaters, what, step_fn, state, batch,
                 dropout_gen, lambda p: loss_of(cfg0, p, kernel_attn),
                 optimizer, ms)
    remat_comparison(torch, mod, cfg, what, state, batch, dropout_gen,
                     step_fn, peak_gb)
    return counts


def bert_train_phase(torch, fa):
    from deeplearning4j_tpu_torch.models import bert

    cfg = bert.bert_base()
    B, T = 32, 128
    batch = bert.synthetic_batch(0, cfg, B, T, device="cuda")

    def loss_of(c, params, attn):
        return bert.mlm_loss(c, params, batch, None, attn)

    counts = train_phase(torch, fa, "BERT-base MLM B=32 T=128", bert, cfg,
                         batch, bert_train_flops(cfg, B, T), loss_of)
    fp32_check(torch, fa, bert, cfg, batch)
    return counts


def fp32_check(torch, fa, bert, cfg, batch) -> None:
    """fp32 compute at depth 2: the CUDA-core flash kernels against the
    plain attention, one step's gradients within 1e-4."""
    from deeplearning4j_tpu_torch.models import transformer as tfm
    from deeplearning4j_tpu_torch.ops import updaters

    c32 = dataclasses.replace(cfg, compute_dtype="float32", n_layers=2,
                              dropout=0.0)
    params = bert.init_params(torch.Generator(device="cuda").manual_seed(2),
                              c32, device="cuda")
    before = fa.launch_counts()
    lk, gk = tfm.value_and_grad(lambda p: bert.mlm_loss(
        c32, p, batch, None, fa.make_attn_fn("auto")), params)
    after = fa.launch_counts()
    lp, gp = tfm.value_and_grad(lambda p: bert.mlm_loss(
        c32, p, batch, None, tfm.attention), params)
    rel, leaf, leaf_rel = grad_agreement(updaters, gk, gp)
    print(f"  BERT-base fp32 compute, depth 2: loss {float(lk):.7f} vs "
          f"{float(lp):.7f}; gradients' global relative L2 error "
          f"{rel:.3e} (tolerance {GRAD_TOL_FP32:g}); largest error in {leaf} "
          f"(relative {leaf_rel:.3e}); fp32 kernel launches "
          f"{ {k: after[k] - before[k] for k in after} }")
    expect = launches_per_step(c32)
    check(all(after[k] - before[k] == expect[k] for k in after),
          f"fp32 step's launches are not {expect}")
    check(rel <= GRAD_TOL_FP32, f"fp32 kernel-path gradients differ by {rel}")


def gpt_train_phase(torch, fa):
    from deeplearning4j_tpu_torch.models import gpt

    cfg = gpt.gpt_config()
    B, T = 8, 1024
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, T))
                           .astype(np.int32)).cuda()

    def loss_of(c, params, attn):
        return gpt.lm_loss(c, params, ids, None, None, attn)

    return train_phase(torch, fa, "GPT-2 small B=8 T=1024", gpt, cfg, ids,
                       gpt_train_flops(cfg, B, T), loss_of)


# ---------------------------------------------------------------------------
# phase 3c: B4 (word2vec chunk) and B5 (GloVe chunk) against their twins
# ---------------------------------------------------------------------------

#: published fp32 rate of an H100 SXM outside the tensor cores (700 W)
PEAK_FP32_FLOPS = 67e12
#: Tolerances of B4/B5 against their plain twins.  A sum of n fp32 terms
#: in any order is within (n-1) * u * sum|t| of the exact sum (u = 2^-24).
#: B4 is held against its twin evaluated in fp64: the fp32 twin, like
#: JAX's .at[].add, adds each of a row's n terms into the table itself,
#: so at the Huffman root (n = 16,384) its own rounding is ~1e-5, larger
#: than the update it checks.  B4 sums each row's terms in registers (and
#: a split row's segments in scratch) and adds a row's mean once: each
#: table is within 2 * n_max * u * t + 4 * u *
#: max|table| of the exact result, with t the largest term (alpha *
#: max|l1| for syn1/syn1neg, alpha * (L+K+1) * max|partner row| for
#: syn0) and n_max the chunk's most-hit row (for syn0 on the wide path,
#: which adds each partner's term on its own, times L+K+1).  B5's twin
#: also sums into zeroed accumulators, in fp32; B5 is held to it entry
#: by entry (see glove_tolerances).
U32 = 2.0 ** -24
#: one training epoch through the kernel against one through the plain
#: twin, same draws: the per-chunk rounding differences compound over the
#: epoch's chunks
EPOCH_TOL = 1e-4
TEXT8 = os.path.join(REPO, "data", "text8")
W2V_CONFIG = dict(vector_size=100, window=5, negative=5, use_hs=True,
                  batch_size=16384)            # bench.py:676-678
ZIPF_VOCAB = 71290        # the min-count-5 vocabulary of public text8
ZIPF_WORDS = 2_000_000


def text8_sentences():
    """data/text8 (tools/make_text_corpus.py) as 50-word sentences."""
    with open(TEXT8) as f:
        words = f.read().split()
    return [" ".join(words[i:i + 50]) for i in range(0, len(words), 50)]


def zipf_sentences():
    """The synthetic Zipf corpus of bench.py:654-660 (exponent 1.05,
    30-word sentences, RandomState(0)) at ZIPF_VOCAB names and about
    ZIPF_WORDS words."""
    rng = np.random.RandomState(0)
    probs = 1.0 / np.arange(1, ZIPF_VOCAB + 1) ** 1.05
    probs /= probs.sum()
    ids = rng.choice(ZIPF_VOCAB, p=probs, size=(-(-ZIPF_WORDS // 30), 30))
    return [" ".join(f"w{i}" for i in row) for row in ids]


def zipf_cache():
    """A vocabulary of all ZIPF_VOCAB names at their expected Zipf counts
    over ZIPF_WORDS words, with Huffman codes."""
    from deeplearning4j_tpu_torch.nlp.vocab import VocabCache, build_huffman

    probs = 1.0 / np.arange(1, ZIPF_VOCAB + 1) ** 1.05
    counts = probs / probs.sum() * ZIPF_WORDS
    cache = VocabCache()
    for i, c in enumerate(counts):
        cache.add_token(f"w{i}", float(c))
    cache.trim(0)
    build_huffman(cache)
    return cache, probs / probs.sum()


def w2v_chunk_inputs(torch, tables, cen, ctx, K, pmask=None, seed=0):
    """One B4 chunk on the card: Huffman rows of the centers, negatives
    from the unigram table.  ``tables`` = prepare_train_tables(...)."""
    codes_t, points_t, mask_t, table, _ = tables
    rng = np.random.RandomState(seed)
    B = cen.size
    negs = table[rng.randint(0, table.size, (B, max(K, 1)))]
    t = lambda a, dt=None: torch.as_tensor(np.ascontiguousarray(a),
                                           device="cuda", dtype=dt)
    return dict(inputs=t(ctx, torch.int32), targets=t(cen, torch.int32),
                codes=t(codes_t[cen], torch.float32),
                points=t(points_t[cen], torch.int32),
                mask=t(mask_t[cen], torch.float32),
                negs=t(negs, torch.int32),
                pmask=t(np.ones(B, np.float32) if pmask is None else pmask))


def w2v_partners(torch, c, use_hs, K):
    """Chunk ``c``'s live hits, one entry per hit: (HS points, negative
    sampling rows, inputs of pairs with a live HS level, inputs of
    unpadded pairs when K > 0)."""
    pts = rows = in_hs = in_ng = c["inputs"][:0].long()
    pm = c["pmask"] > 0
    if use_hs:
        m = (c["mask"] * c["pmask"][:, None]) > 0
        pts, in_hs = c["points"][m].long(), c["inputs"][m.any(1)].long()
    if K > 0:
        r = torch.cat([c["targets"][:, None], c["negs"][:, :K]], 1)
        valid = torch.cat([torch.ones_like(r[:, :1], dtype=torch.bool),
                           r[:, 1:] != r[:, :1]], 1) & pm[:, None]
        rows, in_ng = r[valid].long(), c["inputs"][pm].long()
    return pts, rows, in_hs, in_ng


def w2v_work(torch, c, V0, D, use_hs, K):
    """(bytes, flops, touched rows, the most hits on one row) of chunk
    ``c``: the least work is the index arrays once and each touched row
    of syn0, syn1 and syn1neg read once and written once; 6*D FLOPs per
    live (pair, partner)."""
    B = c["inputs"].shape[0]
    L = c["codes"].shape[1] if use_hs else 0
    pts, rows, in_hs, in_ng = w2v_partners(torch, c, use_hs, K)
    hits = [torch.bincount(x, minlength=V0)
            for x in (torch.cat([in_hs, in_ng]), pts, rows)]
    touched = sum(int((h > 0).sum()) for h in hits)
    nbytes = 4 * B * (3 + 3 * L + K) + 8 * D * touched
    most = max(int(h.max()) if h.numel() else 0 for h in hits)
    return nbytes, 6.0 * D * (pts.numel() + rows.numel()), touched, most


def bound(nbytes, flops):
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def w2v_case_chunks(torch, text8_tables, text8_pairs, zipf):
    """The B4 cases: (name, V, D, K, use_hs, tables, chunk, time_it)."""
    from deeplearning4j_tpu_torch.nlp.word2vec import prepare_train_tables

    cases = []
    rng = np.random.RandomState(0)
    # the JAX test's shape (tests/test_nlp.py:_rand_chunk)
    V, D, L, K, B = 64, 32, 7, 3, 256
    small = dict(inputs=rng.randint(0, V, B), targets=rng.randint(0, V, B),
                 codes=rng.randint(0, 2, (B, L)).astype(np.float32),
                 points=rng.randint(0, V, (B, L)),
                 mask=(rng.rand(B, L) < 0.7).astype(np.float32),
                 negs=rng.randint(0, V, (B, K)),
                 pmask=(rng.rand(B) < 0.9).astype(np.float32))
    small = {k: torch.as_tensor(v, device="cuda",
                                dtype=torch.float32 if v.dtype == np.float32
                                else torch.int32) for k, v in small.items()}
    for name, hs, k in (("JAX test shape, HS only", True, 0),
                        ("JAX test shape, negatives only", False, K),
                        ("JAX test shape, HS + negatives", True, K)):
        cases.append((name, V, D, k, hs, small, False))
    cen, ctx = text8_pairs
    B = 16384
    main = w2v_chunk_inputs(torch, text8_tables, cen[:B], ctx[:B], 5)
    V8 = text8_tables[0].shape[0]
    cases += [("text8 V=2404 D=100 L=14 K=5 B=16384, HS + negatives",
               V8, 100, 5, True, main, True),
              ("text8, HS only", V8, 100, 0, True, main, False),
              ("text8, negatives only", V8, 100, 5, False, main, False)]
    # padded pairs and negative == target collisions
    pm = (rng.rand(B) < 0.7).astype(np.float32)
    pad = w2v_chunk_inputs(torch, text8_tables, cen[:B], ctx[:B], 5, pm,
                           seed=1)
    hit = torch.as_tensor(rng.rand(B, 5) < 0.2, device="cuda")
    pad["negs"] = torch.where(hit, pad["targets"][:, None], pad["negs"])
    cases.append(("text8, 30% padded pairs, 20% negatives == target", V8,
                  100, 5, True, pad, False))
    for d in (50, 300, 600):
        wide = ", the wide path (D > 512)" if d > 512 else ""
        cases.append((f"text8, D={d}{wide}", V8, d, 5, True, main, False))
    zcache, probs = zipf
    ztables = prepare_train_tables(zcache, 100_000)
    zc = rng.choice(ZIPF_VOCAB, p=probs, size=B)
    zx = rng.choice(ZIPF_VOCAB, p=probs, size=B)
    cases.append((f"Zipf V={ZIPF_VOCAB} D=100 L={ztables[0].shape[1]} K=5 "
                  f"B=16384, HS + negatives", ZIPF_VOCAB, 100, 5, True,
                  w2v_chunk_inputs(torch, ztables, zc, zx, 5), True))
    return cases


def w2v_tolerances(torch, c, args, use_hs, K):
    """B4's per-table tolerances (syn0, syn1, syn1neg) for chunk ``c``
    (see U32 above), from its hit counts and the tables' largest |x|."""
    syn0, syn1, sneg = args[:3]
    alpha = args[-1]

    def most(x):
        return int(torch.bincount(x).max()) if x.numel() else 0

    pts, rows, in_hs, in_ng = w2v_partners(torch, c, use_hs, K)
    l1 = syn0.abs().max().item()
    partner = max(syn1.abs().max().item(), sneg.abs().max().item())
    L = c["codes"].shape[1] if use_hs else 0
    # the wide path (D > 512) adds each partner's term into acc0 on its
    # own: L + K + 1 times the terms a row's sum takes
    wide = L + K + 1 if syn0.shape[1] > 512 else 1
    return [2 * n * U32 * alpha * term + 4 * U32 * table.abs().max().item()
            for n, term, table in (
                (wide * max(most(in_hs), most(in_ng)), (L + K + 1) * partner,
                 syn0),
                (most(pts), l1, syn1), (most(rows), l1, sneg))]


def w2v_kernel_phase(torch, fw, cases):
    """B4 against its plain twin on every case; times at the main-path
    shapes.  Returns (worst |diff|, timing rows)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(99)
    worst, rows = 0.0, []
    for name, V, D, K, hs, c, time_it in cases:
        syn = [torch.randn((V, D), generator=gen, device="cuda") * 0.1
               for _ in range(3)]
        syn1 = syn[1] if hs else torch.zeros((1, D), device="cuda")
        sneg = syn[2] if K else torch.zeros((1, D), device="cuda")
        args = (syn[0], syn1, sneg, c["inputs"], c["targets"], c["codes"],
                c["points"], c["mask"], c["negs"][:, :max(K, 1)],
                c["pmask"], 0.025)
        kw = dict(use_hs=hs, negative=K)
        # B4 updates the tables it is given in place; the twins reuse args
        got = fw.fused_chunk_update_cuda(*(a.clone() for a in args[:3]),
                                         *args[3:], **kw)
        ref = fw.fused_chunk_update_plain(
            *(a.double() if torch.is_tensor(a) and a.is_floating_point()
              else a for a in args), **kw)
        torch.cuda.synchronize()
        errs = [(g.double() - r).abs().max().item()
                for g, r in zip(got, ref)]
        # the fp32 twin's own rounding, for scale: it adds each term into
        # the table itself (as JAX's .at[].add), B4 adds a row's mean once
        twin32 = fw.fused_chunk_update_plain(*args, **kw)
        twin_errs = [(t.double() - r).abs().max().item()
                     for t, r in zip(twin32, ref)]
        tols = w2v_tolerances(torch, c, args, hs, K)
        ok = all(e <= t for e, t in zip(errs, tols)) and all(
            bool(g.isfinite().all()) for g in got)
        print(f"  B4 case {name!r}: max|diff| vs the fp64 twin syn0 "
              f"{errs[0]:.3e} syn1 "
              f"{errs[1]:.3e} syn1neg {errs[2]:.3e} (tolerances "
              + " ".join(f"{t:.2e}" for t in tols)
              + f") {'ok' if ok else 'FAIL'}; the fp32 twin vs the fp64 "
              f"twin: " + " ".join(f"{e:.3e}" for e in twin_errs))
        check(ok, f"B4 disagrees with its plain twin: {name}")
        worst = max(worst, *errs)
        if time_it:
            tabs = [a.clone() for a in args[:3]]

            def call():
                fw.fused_chunk_update_cuda(*tabs, *args[3:], **kw)

            ms, by = profile_call_ms(torch, call)
            call_ms = time_ms(torch, call, iters=20)
            plain_ms = time_ms(torch, lambda: fw.fused_chunk_update_plain(
                *args, **kw), iters=10)
            nbytes, flops, touched, most = w2v_work(torch, c, V, D, hs, K)
            b_ms, b_by = bound(nbytes, flops)
            print(f"  B4 timing {name!r}: kernels {ms:.4f} ms a call "
                  f"[profiler, every phase summed: "
                  + phases(by, W2V_PHASES)
                  + f"], whole update call {call_ms:.4f} ms [events], plain "
                  f"twin {plain_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by}: "
                  f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP); "
                  f"{touched} touched rows, at most {most} hits on one, "
                  f"segments of {fw.SEGMENT}; library: none (no one PyTorch "
                  f"call computes it)")
            check(ms > 0, "the profiler saw no device time for B4")
            rows.append((name, ms, plain_ms, b_ms, b_by, call_ms))
    return worst, rows


#: the kernels (and memset) of one B4 call, by phase
W2V_PHASES = ("Memset", "w2v_phase_a", "scan_kernel", "scatter_kernel",
              "w2v_reduce_syn_kernel", "w2v_reduce_syn0_kernel")
#: and of one B5 call
GLOVE_PHASES = ("Memset", "glove_score", "scan_kernel", "scatter_kernel",
                "glove_reduce_kernel", "glove_apply_kernel")


def glove_case_chunks(torch, text8_triples, zipf_probs):
    rng = np.random.RandomState(3)
    cases = []

    def chunk(V, D, rows, cols, x, mask):
        t = torch.as_tensor
        return (V, D, t(rows, device="cuda", dtype=torch.int32),
                t(cols, device="cuda", dtype=torch.int32),
                t(x, device="cuda", dtype=torch.float32),
                t(mask, device="cuda", dtype=torch.float32))

    V, B = 64, 128
    cases.append(("V=64 D=32 B=128 (the JAX test's shape)", False, False,
                  chunk(V, 32, rng.randint(0, V, B), rng.randint(0, V, B),
                        rng.rand(B) * 50 + 1,
                        (rng.rand(B) < 0.9).astype(np.float32))))
    B = 4096
    r, c, x, V8 = text8_triples
    sel = rng.permutation(r.size)[:B]
    cases.append((f"text8 V={V8} D=100 B=4096", True, True,
                  chunk(V8, 100, r[sel], c[sel], x[sel], np.ones(B))))
    zr = rng.choice(ZIPF_VOCAB, p=zipf_probs, size=B)
    zc = rng.choice(ZIPF_VOCAB, p=zipf_probs, size=B)
    zx = np.exp(rng.uniform(np.log(0.1), np.log(1000.0), B))
    cases.append((f"Zipf V={ZIPF_VOCAB} D=100 B=4096, x from 0.1 to 1000",
                  True, True, chunk(ZIPF_VOCAB, 100, zr, zc, zx,
                                    np.ones(B))))
    cases.append(("text8, x on both sides of x_max, 25% masked", False, True,
                  chunk(V8, 100, r[sel], c[sel], zx,
                        (rng.rand(B) < 0.75).astype(np.float32))))
    cases.append(("text8 D=600 B=4096, the wide path (D+2 > 512)", False,
                  True, chunk(V8, 600, r[sel], c[sel], x[sel], np.ones(B))))
    return cases


def glove_tolerances(torch, args, x_max, power):
    """B5's per-entry tolerances (accw, accwt, loss sums) for one chunk,
    worked out in fp64.  Kernel and twin each compute an entry's n terms
    t in fp32, each within dt of the exact term, and sum them in some
    order within n * u * sum|t|, so the two differ by at most 2 * (n * u
    * sum|t| + sum dt).  dt comes from the score: an fp32 dot of E
    products and a log are within dd = (E + 3) * u * (sum|wi * wj| +
    |log x|) of exact, so g = f * diff * m is within f * dd * m + 6 * u
    * |g|, a gradient term g * p within |p| * dg + u * |g * p|, its
    square within 2 * |g * p| * dt + u * (g * p)^2 and a loss term
    0.5 * f * diff^2 * m within f * |diff| * dd * m + 6 * u * loss."""
    wext, wtext, r, c, x, m = (a.double() if a.is_floating_point()
                               else a.long() for a in args)
    V, E = wext.shape
    D = E - 2
    wi, wj = wext[r], wtext[c]
    prod = wi * wj
    logx = torch.log(x.clamp_min(1e-12))
    diff = prod.sum(1) - logx
    fx = ((x / x_max) ** power).clamp_max(1.0)
    g = fx * diff * m
    dd = (E + 3) * U32 * (prod.abs().sum(1) + logx.abs())
    dg = fx * dd * m + 6 * U32 * g.abs()
    live = (m != 0).double()

    def side(idx, partner):
        t = g[:, None] * partner
        dt = partner.abs() * dg[:, None] + U32 * t.abs()
        size = torch.cat([t.abs(), t * t, m[:, None].abs()], 1)
        err = torch.cat([dt, 2 * t.abs() * dt + U32 * t * t,
                         torch.zeros_like(m[:, None])], 1)
        zero = torch.zeros((V, 2 * D + 3), dtype=torch.float64,
                           device=wext.device)
        n = torch.zeros(V, dtype=torch.float64, device=wext.device
                        ).index_add_(0, idx, live)
        return 2 * (n[:, None] * U32 * zero.index_add(0, idx, size)
                    + zero.index_add(0, idx, err))

    loss = 0.5 * fx * diff * diff * m
    dloss = fx * diff.abs() * dd * m + 6 * U32 * loss
    n = live.sum()
    tol_loss = 2 * torch.stack([n * U32 * loss.abs().sum() + dloss.sum(),
                                n * U32 * m.abs().sum()])[None, :]
    return (side(r, wj[:, :D + 1]),
            side(c, torch.cat([wi[:, :D], wi[:, D + 1:]], 1)), tol_loss)


def glove_step_tolerances(torch, fg, args, gext, gtext, alpha, x_max,
                          power):
    """B5's chunk step against glove_chunk_step_plain, per entry of
    (wext, wtext, gext, gtext), worked out in fp64: glove_tolerances
    bounds the two's sums (ds, dq) and the AdaGrad step carries them,
    with k the row's hits, as grad = s/k within ds/k + 2u|grad|, g2 =
    gsq + q/k^2 within dq/k^2 + 4u|g2|, step = alpha * grad / sqrt(G),
    G = g2 + 1e-8, within alpha * dgrad / sqrt(G) + alpha * |grad| *
    dg2 / (2 G^1.5) + 6u|step|, and the new weight within dstep +
    2u|w - step|."""
    acc_tols = glove_tolerances(torch, args, x_max, power)
    wext, wtext, r, c, x, m = (a.double() if a.is_floating_point() else a
                               for a in args)
    accs = fg.fused_glove_chunk_plain(wext, wtext, r, c, x, m, x_max=x_max,
                                      power=power)
    D = wext.shape[1] - 2
    d1 = D + 1
    out = []
    for acc, tol, table_b, gsq in (
            (accs[0], acc_tols[0], wext[:, :d1], gext.double()),
            (accs[1], acc_tols[1],
             torch.cat([wtext[:, :D], wtext[:, D + 1:]], 1), gtext.double())):
        k = acc[:, 2 * d1:].clamp_min(1.0)
        grad = acc[:, :d1] / k
        g2 = gsq + acc[:, d1:2 * d1] / (k * k)
        G = g2 + 1e-8
        step = alpha * grad / G.sqrt()
        dgrad = tol[:, :d1] / k + 2 * U32 * grad.abs()
        dg2 = tol[:, d1:2 * d1] / (k * k) + 4 * U32 * g2.abs()
        dstep = (alpha * dgrad / G.sqrt()
                 + alpha * grad.abs() * dg2 / (2 * G ** 1.5)
                 + 6 * U32 * step.abs())
        out.append((dstep + 2 * U32 * (table_b - step).abs(), dg2))
    zero = torch.zeros_like(out[0][0][:, :1])
    (dwi, dgi), (dwj, dgj) = out
    return (torch.cat([dwi, zero], 1),                       # (w | b | 1)
            torch.cat([dwj[:, :D], zero, dwj[:, D:]], 1),    # (wt | 1 | bt)
            dgi, dgj)


def glove_kernel_phase(torch, fg, cases):
    """B5's accumulator mode against fused_glove_chunk_plain on every
    case, its chunk step against glove_chunk_step_plain on the step
    cases, and at the timed shapes the step's device time beside the old
    composition's.  Returns (worst |diff|, timing rows)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    worst, rows = 0.0, []
    for name, time_it, step_case, (V, D, r, c, x, m) in cases:
        ones = torch.ones((V, 1), device="cuda")
        w, wt = (torch.randn((V, D), generator=gen, device="cuda") * 0.1
                 for _ in range(2))
        b, bt = (torch.randn((V, 1), generator=gen, device="cuda") * 0.1
                 for _ in range(2))
        args = (torch.cat([w, b, ones], 1), torch.cat([wt, ones, bt], 1),
                r, c, x, m)
        kw = dict(x_max=100.0, power=0.75)
        got = fg.fused_glove_chunk_cuda(*args, **kw)
        ref = fg.fused_glove_chunk_plain(*args, **kw)
        torch.cuda.synchronize()
        tols = glove_tolerances(torch, args, **kw)
        errs, ratios = [], []
        for g, rf, tol in zip(got, ref, tols):
            diff = (g.double() - rf.double()).abs()
            errs.append(diff.max().item())
            ratios.append(float((diff / tol.clamp_min(1e-300)).max()))
        ok = all(ratio <= 1.0 for ratio in ratios) and all(
            bool(g.isfinite().all()) for g in got)
        d1 = D + 1

        def blocks(tol):       # the largest tolerance per column block
            return "|".join(f"{float(tol[:, a:b].max()):.2e}" for a, b in (
                (0, d1), (d1, 2 * d1), (2 * d1, 2 * d1 + 1)))

        print(f"  B5 case {name!r}: max|diff| accw {errs[0]:.3e} accwt "
              f"{errs[1]:.3e} loss {errs[2]:.3e}; largest diff/tolerance "
              f"per entry " + " ".join(f"{q:.3f}" for q in ratios)
              + f" {'ok' if ok else 'FAIL'}; largest tolerance per block "
              f"(grad|grad^2|hits) accw {blocks(tols[0])} accwt "
              f"{blocks(tols[1])}, loss sums "
              + " ".join(f"{float(t):.2e}" for t in tols[2][0]))
        check(ok, f"B5 disagrees with its plain twin: {name}")
        worst = max(worst, *errs)
        if not step_case:
            continue

        # the fused chunk step, in place on copies, against its twin
        gext, gtext = (torch.rand((V, d1), generator=gen, device="cuda")
                       * 0.1 + 1e-8 for _ in range(2))
        alpha = 0.05
        state = (args[0], args[1], gext, gtext)
        *step_ref, ls_ref = fg.glove_chunk_step_plain(*state, *args[2:],
                                                      alpha, **kw)
        *step_got, ls = fg.glove_chunk_step_cuda(
            *(t.clone() for t in state), *args[2:], alpha, **kw)
        torch.cuda.synchronize()
        step_tols = glove_step_tolerances(torch, fg, args, gext, gtext,
                                          alpha, **kw)
        step_ratios = [float(((g.double() - rf.double()).abs()
                              / tol.clamp_min(1e-300)).max())
                       for g, rf, tol in zip(step_got, step_ref, step_tols)]
        loss_ratio = float(((ls.double() - ls_ref.double()).abs()
                            / tols[2].clamp_min(1e-300)).max())
        step_errs = [float((g - rf).abs().max())
                     for g, rf in zip(step_got, step_ref)]
        ok = (max(step_ratios + [loss_ratio]) <= 1.0
              and all(bool(g.isfinite().all()) for g in step_got))
        print(f"  B5 step case {name!r}: max|diff| wext {step_errs[0]:.3e} "
              f"wtext {step_errs[1]:.3e} gext {step_errs[2]:.3e} gtext "
              f"{step_errs[3]:.3e}; largest diff/tolerance per entry "
              + " ".join(f"{q:.3f}" for q in step_ratios)
              + f", loss {loss_ratio:.3f} {'ok' if ok else 'FAIL'}")
        check(ok, f"B5's chunk step disagrees with its plain twin: {name}")
        worst = max(worst, *step_errs)
        if not time_it:
            continue
        tabs = [t.clone() for t in state]

        def fused():
            fg.glove_chunk_step_cuda(*tabs, *args[2:], alpha, **kw)

        def old_composition():
            wext, wtext, gx, gt = tabs
            accw, accwt, _ = fg.fused_glove_chunk_cuda(wext, wtext,
                                                       *args[2:], **kw)
            wb, gx2 = fg.apply_chunk(wext[:, :D + 1], gx, accw, alpha)
            wtb, gt2 = fg.apply_chunk(
                torch.cat([wtext[:, :D], wtext[:, D + 1:]], 1), gt, accwt,
                alpha)
            wext[:, :D + 1] = wb
            wtext[:, :D] = wtb[:, :D]
            wtext[:, D + 1] = wtb[:, D]
            gx.copy_(gx2)
            gt.copy_(gt2)

        old_ms, _ = profile_call_ms(torch, old_composition)
        ms, by = profile_call_ms(torch, fused)
        old_ms2, _ = profile_call_ms(torch, old_composition)
        plain_ms = time_ms(torch, lambda: fg.glove_chunk_step_plain(
            *state, *args[2:], alpha, **kw), iters=10)
        # the four [B] inputs once; each touched row of each side: its
        # extended row read, its D+1 update columns and AdaGrad sums read
        # and written
        live = m > 0
        rows_hit = (torch.unique(r[live]).numel()
                    + torch.unique(c[live]).numel())
        nbytes = 16 * r.numel() + 4 * rows_hit * (4 * D + 5) + 8
        flops = 6.0 * D * int(live.sum())
        b_ms, b_by = bound(nbytes, flops)
        old = min(old_ms, old_ms2)
        print(f"  B5 timing {name!r}: chunk step {ms:.4f} ms [profiler, "
              f"every phase summed: " + phases(by, GLOVE_PHASES)
              + f"]; the old composition (accumulators, two apply_chunk, "
              f"cat, slice writes) {old_ms:.4f} / {old_ms2:.4f} ms, the step "
              f"at {ms / old:.2f}x of it; plain twin {plain_ms:.4f} ms; "
              f"bound {b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.2f} MB, "
              f"{flops / 1e9:.3f} GFLOP); library: none (no one PyTorch "
              f"call computes it)")
        check(ms > 0, "the profiler saw no device time for B5")
        rows.append((name, ms, plain_ms, b_ms, b_by, old))
    return worst, rows


# ---------------------------------------------------------------------------
# phases 7 and 8: word2vec, ParagraphVectors and GloVe training
# ---------------------------------------------------------------------------

def busy_share(torch, run):
    """(device busy ms, wall ms) of one call of ``run``, torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return busy, wall


def rel_diff(torch, got, ref):
    """(max |diff| over the tables, global relative L2 difference)."""
    err = max((g - r).abs().max().item() for g, r in zip(got, ref))
    num = sum(float((g - r).double().norm()) ** 2 for g, r in zip(got, ref))
    den = sum(float(r.double().norm()) ** 2 for r in ref)
    return err, (num / max(den, 1e-30)) ** 0.5


def w2v_fit(torch, fw, what, sents, cfg, cache=None, w2v=None):
    """One fit, timed on the host clock after synchronize, with B4's
    launches read around it and held to one per chunk.  Returns the
    Word2Vec, seconds and launches."""
    from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec

    w2v = w2v or Word2Vec(sents, cfg, cache=cache, device="cuda")
    fw.reset_launches()
    t0 = time.perf_counter()
    w2v.fit()
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    n = fw.launches
    check(w2v.chunks > 0 and n == w2v.chunks,
          f"{what}: B4 launched {n} times for {w2v.chunks} chunks")
    tabs = [t for t in (w2v.syn0, w2v.syn1, w2v.syn1neg) if t is not None]
    check(all(bool(t.isfinite().all()) for t in tabs),
          f"{what}: non-finite tables")
    words = w2v._n_positions * cfg.epochs
    print(f"  {what}: {cfg.epochs} epochs, {w2v._n_positions} words, "
          f"V={len(w2v.cache)}, {w2v.chunks} chunks = {n} B4 launches, "
          f"{sec:.3f} s, {words / sec:.1f} words/s (host clock, "
          f"synchronized)")
    return w2v, sec, n


def neighbour_check(wv, what):
    """tests/test_nlp.py:test_word2vec_real_corpus_tier's check."""
    check(len(wv.cache) > 1000, f"{what}: vocabulary {len(wv.cache)}")
    probe = next((w for w in ("the", "of", "and", "one")
                  if w in wv.cache.vocab), wv.cache.word_for(0))
    near = wv.words_nearest(probe, 5)
    print(f"  {what}: nearest to {probe!r}: "
          + ", ".join(f"{w} {s:.3f}" for w, s in near))
    check(len(near) == 5 and all(np.isfinite(s) for _, s in near),
          f"{what}: neighbour check failed: {near}")


def word2vec_phase(torch, fw, t8, zipf):
    """Phase 7: returns B4's launches over the main paths."""
    from deeplearning4j_tpu_torch.nlp.paragraph_vectors import (
        ParagraphVectors, ParagraphVectorsConfig)
    from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec, Word2VecConfig

    launches = 0
    cfg = Word2VecConfig(min_word_frequency=5, epochs=3, **W2V_CONFIG)
    w2v, sec, n = w2v_fit(torch, fw, "text8 masked, cold fit", t8, cfg)
    launches += n
    cache = w2v.cache
    neighbour_check(w2v.word_vectors, "text8 masked")
    _, sec, n = w2v_fit(torch, fw, "text8 masked, warm refit (cached "
                        "slabs)", t8, cfg, w2v=w2v)
    launches += n
    print(f"  text8 masked: warm epoch {sec / cfg.epochs * 1e3:.1f} ms, "
          f"{w2v._n_positions / (sec / cfg.epochs):.1f} words/s")
    w2v.config = dataclasses.replace(cfg, epochs=1)
    fw.reset_launches()
    busy, wall = busy_share(torch, w2v.fit)
    launches += fw.launches
    print(f"  text8 masked, one profiled epoch: device busy {busy:.2f} ms "
          f"of {wall:.2f} ms wall ({busy / wall:.1%}); "
          f"{fw.launches} B4 launches")
    for mode in ("exact", "device"):
        _, _, n = w2v_fit(torch, fw, f"text8 {mode}, cold fit", t8,
                          dataclasses.replace(cfg, pair_mode=mode),
                          cache=cache)
        launches += n

    # one epoch through B4 against one through the plain twin, same draws
    gen = torch.Generator(device="cuda").manual_seed(5)
    V, D = len(cache), cfg.vector_size
    init = ((torch.rand((V, D), generator=gen, device="cuda") - 0.5) / D,
            torch.randn((V, D), generator=gen, device="cuda") * 0.01,
            torch.randn((V, D), generator=gen, device="cuda") * 0.01)
    out = {}
    for kernel in ("cuda", "plain"):
        one = Word2Vec(t8, dataclasses.replace(cfg, epochs=1, kernel=kernel),
                       cache=cache, device="cuda")
        one.fit(initial_weights=init)
        out[kernel] = (one.syn0, one.syn1, one.syn1neg)
    err, rel = rel_diff(torch, out["cuda"], out["plain"])
    print(f"  text8 masked, one epoch through B4 vs through the plain twin "
          f"(same draws): max|diff| {err:.3e}, relative L2 {rel:.3e} "
          f"(tolerance {EPOCH_TOL:g})")
    check(err <= EPOCH_TOL, "word2vec epoch: B4 and plain twin disagree")

    zcfg = dataclasses.replace(cfg, min_word_frequency=1, epochs=2)
    zw, sec, n = w2v_fit(torch, fw, f"Zipf {ZIPF_VOCAB} names masked, cold "
                         f"fit", zipf, zcfg)
    launches += n
    _, sec, n = w2v_fit(torch, fw, "Zipf masked, warm refit", zipf, zcfg,
                        w2v=zw)
    launches += n
    print(f"  Zipf masked: warm epoch {sec / zcfg.epochs * 1e3:.1f} ms, "
          f"{zw._n_positions / (sec / zcfg.epochs):.1f} words/s")

    docs = [(f"doc{i}", s) for i, s in enumerate(t8)]
    pv = ParagraphVectors(docs, ParagraphVectorsConfig(
        min_word_frequency=5, epochs=3, vector_size=100, window=5,
        batch_size=16384), device="cuda")
    fw.reset_launches()
    t0 = time.perf_counter()
    pv.fit()
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    n = fw.launches
    launches += n
    inferred = pv.infer_vector(t8[0])
    labels = pv.nearest_labels(t8[0])
    print(f"  ParagraphVectors over {len(docs)} text8 documents: 3 epochs, "
          f"{pv.chunks} chunks = {n} B4 launches, {sec:.3f} s; inferred "
          f"|v| {np.linalg.norm(inferred):.4f}; nearest labels {labels}")
    check(pv.chunks > 0 and n == pv.chunks,
          "ParagraphVectors: B4 launches != chunks")
    check(bool(pv.syn0.isfinite().all()) and np.isfinite(inferred).all()
          and len(labels) == 3, "ParagraphVectors: bad result")
    return launches


def glove_fit(torch, fg, what, sents, cfg, cache=None):
    from deeplearning4j_tpu_torch.nlp.glove import (Glove,
                                                    count_cooccurrences)
    from deeplearning4j_tpu_torch.nlp.vocab import build_vocab

    g = Glove(sents, cfg, device="cuda")
    g.cache = cache or build_vocab(sents, g.tokenizer,
                                   cfg.min_word_frequency)
    t0 = time.perf_counter()
    co = count_cooccurrences(sents, g.tokenizer, g.cache, cfg.window,
                             cfg.symmetric)
    t_count = time.perf_counter() - t0
    fg.reset_launches()
    t0 = time.perf_counter()
    g.fit(cooccurrences=co)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    n = fg.launches
    P = co[0].size
    print(f"  {what}: V={len(g.cache)}, {P} triples, counting {t_count:.3f} "
          f"s; {cfg.epochs} epochs, {g.chunks} chunks = {n} B5 launches, "
          f"{sec:.3f} s, {P * cfg.epochs / sec:.1f} triples/s (host clock, "
          f"synchronized); losses " + " ".join(f"{x:.5f}" for x in g.losses))
    check(g.chunks > 0 and n == g.chunks, f"{what}: B5 launches != chunks")
    check(all(np.isfinite(g.losses)) and g.losses[-1] < g.losses[0],
          f"{what}: loss did not fall: {g.losses}")
    check(all(bool(t.isfinite().all()) for t in g.state),
          f"{what}: non-finite state")
    return g, co, n


def glove_phase(torch, fg, t8, zipf):
    """Phase 8: returns B5's launches over the main paths."""
    from deeplearning4j_tpu_torch.nlp.glove import Glove, GloveConfig

    cfg = GloveConfig()
    g, co, launches = glove_fit(torch, fg, "text8 GloVe", t8, cfg)
    one_cfg = dataclasses.replace(cfg, epochs=1)
    prof = Glove(t8, one_cfg, cache=g.cache, device="cuda")
    fg.reset_launches()
    busy, wall = busy_share(torch, lambda: prof.fit(cooccurrences=co))
    launches += fg.launches
    print(f"  text8 GloVe, one profiled epoch: device busy {busy:.2f} ms of "
          f"{wall:.2f} ms wall ({busy / wall:.1%}); {fg.launches} B5 "
          f"launches")
    out = {}
    for kernel in ("cuda", "plain"):
        one = Glove(t8, dataclasses.replace(one_cfg, kernel=kernel),
                    cache=g.cache, device="cuda")
        one.fit(initial_weights=g.state, cooccurrences=co)
        out[kernel] = one.state
    err, rel = rel_diff(torch, out["cuda"], out["plain"])
    print(f"  text8 GloVe, one epoch through B5 vs through the plain twin "
          f"(same permutation): max|diff| {err:.3e}, relative L2 {rel:.3e} "
          f"(tolerance {EPOCH_TOL:g})")
    check(err <= EPOCH_TOL, "GloVe epoch: B5 and plain twin disagree")
    _, _, n = glove_fit(torch, fg, f"Zipf {ZIPF_VOCAB} names GloVe", zipf,
                        dataclasses.replace(cfg, epochs=2))
    return launches + n


# ---------------------------------------------------------------------------
# phase 9: LeNet-MNIST training, evaluation and serving
# ---------------------------------------------------------------------------

LENET_B = 128
LENET_LOSS_RTOL = {"float32": 1e-4, "bfloat16": 5e-2}   # as the CPU tests
LENET_DENSE_TOL = 3e-2     # bf16 dense product, card vs CPU, of max |ref|
LENET_SERVE_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
LENET_MIN_ACC = 0.90       # tests/test_mnist_e2e.py:122 on data/mnist
LENET_TIMED_EPOCHS = 13    # 13 x 16 batches = 208 steps

#: a LeNet step's device kernels by kind, first match wins; cuDNN's own
#: padding and layout kernels count with the convolutions (its cutlass
#: wgrad kernels are named for neither direction)
LENET_KINDS = (("convolutions (cuDNN)", ("conv", "grad", "fprop",
                                         "implicit_gemm", "Padding",
                                         "nhwcTo", "nchwTo", "cudnn")),
               ("GEMMs", GEMM_MARKS), ("max pooling", ("MaxOps",)),
               ("copies and casts", ("copy",)),
               ("finite checks", ("ReduceOp<bool",)))


def lenet_flops(batch: int) -> float:
    """bench.py:500-505: one training step (forward x 3)."""
    macs = (28 * 28 * 25 * 1 * 20 + 14 * 14 * 25 * 20 * 50
            + 7 * 7 * 50 * 500 + 500 * 10)
    return 3.0 * 2.0 * macs * batch


def mnist_split(train: bool):
    from deeplearning4j_tpu_torch.datasets.fetchers import MnistDataFetcher

    f = MnistDataFetcher(train=train, flatten=False, binarize=False)
    check(not f.synthetic, "data/mnist not found")
    f.fetch(f.total)
    return f.next()


def lenet_net(ln, dtype, params, device):
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    return MultiLayerNetwork(
        ln.lenet_conf(compute_dtype=dtype),
        params=[{k: v.to(device) for k, v in p.items()} for p in params],
        device=device)


def lenet_random_batches(n: int, seed: int = 0):
    """``n`` batches of seeded uniform images and labels (the CPU parity
    tests' inputs, tests/test_torch_lenet.py, at B=128)."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet

    rng = np.random.default_rng(seed)
    x = rng.random((n * LENET_B, 28, 28, 1), dtype=np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, n * LENET_B)]
    return DataSet(x, y).batch_by(LENET_B)


def lenet_losses(ln, dtype, params, batches, device):
    from deeplearning4j_tpu_torch.optimize.listeners import \
        CollectScoresListener

    net = lenet_net(ln, dtype, params, device)
    col = CollectScoresListener()
    net.set_listeners([col])
    net.fit_backprop(batches)
    return np.array([v for _, v in col.scores])


def lenet_parity(torch, ln, params, mnist_batches) -> None:
    """The same params and batches through the port on the card and on
    the CPU, fp32 and bf16: held to the bar on seeded random images;
    data/mnist's batches printed beside them, not held: their flat
    saturated regions give max-pool windows that tie in exact
    arithmetic, and each conv algorithm's rounding breaks those ties its
    own way (cuDNN on the card agrees with an im2col conv on the CPU
    over 10 steps, and two CPU convs part by 3e-3:
    tools/lenet_tie_probe.py).  Then pooling ties on the card, and the
    bf16 dense 2450 -> 500 product with cuBLAS's reduced-precision
    reduction on and off."""
    random_batches = lenet_random_batches(len(mnist_batches))
    for dtype, tol in LENET_LOSS_RTOL.items():
        for what, batches in (("seeded random", random_batches),
                              ("data/mnist", mnist_batches)):
            cuda = lenet_losses(ln, dtype, params, batches, "cuda")
            cpu = lenet_losses(ln, dtype, params, batches, "cpu")
            rel = np.abs(cuda - cpu) / np.abs(cpu)
            held = what == "seeded random"
            print(f"  LeNet {dtype}, {what} batches: {len(batches)} steps at "
                  f"B={LENET_B}, card vs CPU: losses "
                  + " ".join(f"{v:.6f}" for v in cuda)
                  + f"; largest relative difference {rel.max():.3e} at "
                  f"step {int(rel.argmax())} "
                  + (f"(tolerance {tol:g})" if held else
                     "(exact ties broken by rounding: not held)"))
            check(bool(np.isfinite(cuda).all()),
                  f"LeNet {dtype}: non-finite loss on the card")
            if held and dtype == "float32":
                again = lenet_losses(ln, dtype, params, batches, "cuda")
                print(f"  LeNet {dtype}, {what} batches: a second card run "
                      f"against the first: largest relative difference "
                      f"{(np.abs(again - cuda) / np.abs(cuda)).max():.3e}")
            if held:
                check(rel.max() <= tol, f"LeNet {dtype}: card and CPU "
                                        f"losses differ by {rel.max()}")

    # max pooling must send a tied window's gradient to its first
    # largest entry (XLA's select_and_scatter) on the card too
    from deeplearning4j_tpu_torch.nn.conf.configuration import (
        LayerKind, NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.layers import make_layer

    pool = make_layer(NeuralNetConfiguration(kind=LayerKind.SUBSAMPLING,
                                             pool_size=(2, 2)))
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.integers(0, 3, (LENET_B, 28, 28, 20))
                         .astype(np.float32))
    dy = torch.from_numpy(rng.normal(size=(LENET_B, 14, 14, 20))
                          .astype(np.float32))
    grads = []
    for dev in ("cuda", "cpu"):
        xd = x.to(dev).requires_grad_(True)
        (pool.activate({}, xd) * dy.to(dev)).sum().backward()
        grads.append(xd.grad.cpu())
    print(f"  LeNet max pooling on a tie-heavy input: card and CPU "
          f"gradients {'equal' if torch.equal(*grads) else 'DIFFER'}")
    check(torch.equal(*grads), "max pooling routes ties differently on "
                               "the card")

    cuda_net = lenet_net(ln, "bfloat16", params, "cuda")
    cpu_net = lenet_net(ln, "bfloat16", params, "cpu")
    x = mnist_batches[0].features
    with torch.no_grad():
        h = cpu_net.feed_forward(cpu_net.params, x, upto=4)[-1]
        h = h.reshape(h.shape[0], -1)
        dense = cpu_net.layers[4]
        ref = dense.pre_output(cpu_net.params[4], h)
        matmul = torch.backends.cuda.matmul
        flag = matmul.allow_bf16_reduced_precision_reduction
        errs = {}
        for on in (True, False):
            matmul.allow_bf16_reduced_precision_reduction = on
            got = dense.pre_output(cuda_net.params[4], h.cuda()).cpu()
            errs[on] = float((got - ref).abs().max() / ref.abs().max())
        matmul.allow_bf16_reduced_precision_reduction = flag
    print(f"  LeNet bf16 dense 2450->500 at B={LENET_B}, card vs CPU, max "
          f"|diff| / max |ref|: {errs[True]:.3e} with cuBLAS's reduced-"
          f"precision bf16 reduction allowed, {errs[False]:.3e} without "
          f"(tolerance {LENET_DENSE_TOL:g}; the port leaves the flag at "
          f"{flag})")
    check(errs[flag] <= LENET_DENSE_TOL,
          f"bf16 dense product differs from the CPU's by {errs[flag]}")


def profile_kernels(torch, run):
    """{kernel name: (device ms, launches)} of one call of ``run``, and
    its wall ms (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return ({e.key: (e.self_device_time_total / 1e3, e.count)
             for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and e.self_device_time_total > 0}, wall)


def lenet_kind(name: str) -> str:
    for kind, marks in LENET_KINDS:
        if any(m in name for m in marks):
            return kind
    return "elementwise and the rest"


def lenet_times(torch, ln, batches, steps_per_epoch: int,
                card: str) -> None:
    """Steady-state step time at B=128 on batches already on the card:
    the median of >= 200 steps on the host clock (each step synchronized
    by a listener reading its loss), the same steps unsynchronized
    between CUDA events, one
    profiled epoch's busy share and device ms by kernel kind, and the
    peak memory."""
    from deeplearning4j_tpu_torch.datasets.iterator import \
        ListDataSetIterator
    from deeplearning4j_tpu_torch.optimize.listeners import TimingListener

    from deeplearning4j_tpu_torch.datasets.dataset import DataSet

    batches = [DataSet(b.features.cuda(), b.labels.cuda()) for b in batches]
    net = ln.lenet(device="cuda")
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() / 1e6
    torch.cuda.reset_peak_memory_stats()     # the warm-up captures the step
    net.fit_backprop(batches)                       # warm-up epoch
    torch.cuda.synchronize()
    timer = TimingListener()
    net.set_listeners([timer])
    net.fit_iterator(ListDataSetIterator(batches, LENET_B),
                     num_epochs=LENET_TIMED_EPOCHS)
    step_ms = [d * 1e3 for d in timer.durations[1:]]
    check(len(step_ms) >= 200, f"{len(step_ms)} timed steps")
    med = float(np.median(step_ms))
    net.set_listeners([])
    n_steps = LENET_TIMED_EPOCHS * steps_per_epoch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    net.fit_backprop(batches, num_epochs=LENET_TIMED_EPOCHS)
    end.record()
    end.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / n_steps
    ev = start.elapsed_time(end) / n_steps
    peak = torch.cuda.max_memory_allocated() / 1e6
    flops = lenet_flops(LENET_B)
    print(f"  LeNet bf16 step at B={LENET_B} on {card}: {med:.3f} ms "
          f"median of "
          f"{len(step_ms)} (host clock, each step synchronized; min "
          f"{min(step_ms):.3f}, max {max(step_ms):.3f}) = "
          f"{LENET_B / med * 1e3:.1f} samples/s; fit_backprop's staged "
          f"path, {n_steps} steps with no sync between: {ev:.3f} ms a "
          f"step between CUDA events ({wall:.3f} ms host clock) = "
          f"{LENET_B / ev * 1e3:.1f} samples/s; model FLOPs "
          f"{flops / 1e9:.2f} GFLOP a step = "
          f"{flops / (ev / 1e3) / PEAK_BF16_FLOPS:.3%} of 989 TFLOP/s; "
          f"peak memory {peak:.1f} MB, {held:.1f} MB of it allocated "
          f"before the warm-up (earlier phases' engine entries and the "
          f"batches)")

    by, wall = profile_kernels(torch, lambda: net.fit_backprop(batches))
    if not by:
        print("  LeNet profile: no device time reported (not measured)")
        return
    busy = sum(ms for ms, _ in by.values())
    launches = sum(n for _, n in by.values())
    kinds = {}
    for name, (ms, n) in by.items():
        k = kinds.setdefault(lenet_kind(name), [0.0, 0])
        k[0] += ms
        k[1] += n
    print(f"  LeNet profile of one epoch ({steps_per_epoch} steps) on "
          f"{card}: device "
          f"busy {busy:.3f} ms of {wall:.3f} ms wall = {busy / wall:.1%}; "
          f"{launches} kernels = {launches / steps_per_epoch:.1f} a step; "
          f"device ms a step by kind: " + "; ".join(
              f"{kind} {ms / steps_per_epoch:.4f} ms ({n / steps_per_epoch:.1f}"
              f" kernels)" for kind, (ms, n) in
              sorted(kinds.items(), key=lambda kv: -kv[1][0])))
    for name, (ms, n) in sorted(by.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"    {ms / steps_per_epoch:8.4f} ms a step, {n:5d} launches  "
              f"{name[:100]}")


def lenet_serving_check(torch, ln, net, test) -> None:
    """A served mixed-size stream through the warmed engine (bf16, and
    the same params at fp32) against the unpadded forward."""
    for dtype in ("bfloat16", "float32"):
        snet = lenet_net(ln, dtype, net.params, "cuda")
        t0 = time.perf_counter()
        eng = ln.lenet_serving(snet)
        warm = (time.perf_counter() - t0) * 1e3
        worst, lat = 0.0, []
        for n in (1, 3, 17, 100, 128, 200, 300, 512):
            x = test.features[:n]
            t0 = time.perf_counter()
            out = eng.infer(x, sync=True)
            lat.append((n, (time.perf_counter() - t0) * 1e3))
            with torch.inference_mode():
                ref = snet.feed_forward(snet.params, x.cuda())[-1]
            check(tuple(out.shape) == (n, 10), f"served shape {out.shape}")
            worst = max(worst, float((out - ref).abs().max()))
        print(f"  LeNet serving {dtype}: {len(eng.buckets)} buckets "
              f"{eng.buckets} warmed in {warm:.1f} ms; stream of "
              + ", ".join(f"{n} rows {ms:.2f} ms" for n, ms in lat)
              + f" (host clock, synchronized); largest |diff| to the "
              f"unpadded forward {worst:.3e} (tolerance "
              f"{LENET_SERVE_TOL[dtype]:g})")
        check(worst <= LENET_SERVE_TOL[dtype],
              f"LeNet {dtype}: served rows differ from the unpadded "
              f"forward by {worst}")


def lenet_phase(torch, ln, card: str) -> None:
    """Phase 9 (see the module docstring)."""
    from deeplearning4j_tpu_torch.datasets.iterator import \
        MnistDataSetIterator

    t0 = time.perf_counter()
    train, test = mnist_split(True), mnist_split(False)
    batches = train.batch_by(LENET_B)
    print(f"  data/mnist: {train.num_examples()} train, "
          f"{test.num_examples()} test images; {len(batches)} batches of "
          f"{LENET_B}; read in {time.perf_counter() - t0:.2f} s")
    params = ln.lenet(device="cpu").params
    lenet_parity(torch, ln, params, batches[:10])

    for how in ("fit_backprop", "fit_iterator"):
        net = ln.lenet(device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if how == "fit_backprop":
            net.fit_backprop(batches, num_epochs=2)
        else:
            net.fit_iterator(MnistDataSetIterator(
                LENET_B, binarize=False, flatten=False), num_epochs=2)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        ev = net.evaluate(test)
        print(f"  LeNet bf16 {how}, 2 epochs: {sec:.3f} s (host clock, "
              f"synchronized); test accuracy {ev.accuracy():.4f}, f1 "
              f"{ev.f1():.4f} over {ev.confusion.total()} images (bar "
              f"{LENET_MIN_ACC}); guard skips {net.guard_skips}")
        check(ev.accuracy() >= LENET_MIN_ACC,
              f"LeNet {how}: test accuracy {ev.accuracy()}")
    lenet_serving_check(torch, ln, net, test)
    lenet_times(torch, ln, batches, len(batches), card)


# ---------------------------------------------------------------------------
# phase 10: GPT-2 small generation serving
# ---------------------------------------------------------------------------

#: the device phase 10 runs on (a CPU rehearsal substitutes "cpu")
GEN_DEVICE = "cuda"
GEN_PROMPTS, GEN_PROMPT_LEN, GEN_TOKENS = 4, 128, 64
#: teacher-forced decode logits vs the dense forward (phase 4's bf16 bar)
GEN_LOGITS_TOL = {"bfloat16": LOGITS_TOL, "float32": 1e-3}
GEN_SLOTS = 8
BURST, BURST_MIN, BURST_MAX, BURST_TOKENS, BURST_TEMP = 32, 16, 512, 64, 0.8
#: the burst's first requests run again as sequential solo generate
#: calls for the tokens/s comparison (printed only; all 32 took 27.9 s)
SOLO_REQS = 8
#: greedy parity with solo generate holds up to the first step whose
#: top-2 margin (solo run, fp32) is below this
PARITY_MARGIN = 1e-3
#: int8 logits, card vs CPU, of max(|CPU|, 1) (test_serving_tier2.py:204)
KV_DRIFT = 0.05
SCORING_T, SCORING_BUCKETS, SCORING_ROWS = 1024, (1, 2, 4), (1, 3, 4)


def gen_config(gpt):
    """GPT-2 small, bf16 (gpt.gpt_config())."""
    return gpt.gpt_config()


def top2_margin(torch, logits):
    top = torch.topk(logits.float(), 2, dim=-1).values
    return top[..., 0] - top[..., 1]


def decode_against_dense(torch, gpt, cfg, params, say) -> None:
    """(a) generate's prefill and decode-step logits, teacher-forced,
    against forward_logits over the prompt and the generated tokens, in
    bf16 and fp32; greedy tokens against the dense argmax wherever its
    top-2 margin exceeds the bar."""
    rng = np.random.default_rng(7)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (GEN_PROMPTS, GEN_PROMPT_LEN)).astype(np.int32)
    ).to(GEN_DEVICE)
    for c in (cfg, dataclasses.replace(cfg, compute_dtype="float32")):
        bar = GEN_LOGITS_TOL[c.compute_dtype]
        t0 = time.perf_counter()
        toks, logits = gpt.generate(c, params, prompts, GEN_TOKENS,
                                    temperature=0.0, return_logits=True)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        with torch.inference_mode():
            dense = gpt.forward_logits(
                c, params, torch.cat([prompts, toks], dim=1))[
                    :, GEN_PROMPT_LEN - 1:GEN_PROMPT_LEN - 1 + GEN_TOKENS]
        err = (logits - dense).abs().max().item()
        resolved = top2_margin(torch, dense) > bar
        agree = (toks.long() == dense.argmax(-1))[resolved]
        say(f"(a) {c.compute_dtype}: generate {GEN_PROMPTS} x "
            f"{GEN_PROMPT_LEN} prompt tokens + {GEN_TOKENS} greedy tokens "
            f"in {sec:.3f} s; prefill and step logits vs forward_logits "
            f"max|diff| {err:.3e} (bar {bar}); greedy = dense argmax at "
            f"{int(agree.sum())}/{agree.numel()} positions whose top-2 "
            f"margin exceeds the bar ({toks.numel()} in all)")
        check(bool(torch.isfinite(logits).all()), "decode logits non-finite")
        check(torch.allclose(logits, dense, rtol=bar, atol=bar),
              f"{c.compute_dtype} decode logits differ from the dense "
              f"forward by {err} (bar {bar})")
        check(bool(agree.all()), f"{c.compute_dtype} greedy tokens differ "
                                 f"from the dense argmax where it resolves")


def burst_requests(cfg):
    """32 seeded requests: prompt lengths 16-512, even ones greedy, odd
    ones sampled at 0.8, each with its own seed."""
    rng = np.random.default_rng(8)
    reqs = []
    for i in range(BURST):
        n = int(rng.integers(BURST_MIN, BURST_MAX + 1))
        reqs.append((rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                     0.0 if i % 2 == 0 else BURST_TEMP, 1000 + i))
    return reqs


def serve_burst(torch, eng, reqs, tokens: int = BURST_TOKENS):
    """Every request submitted at once to a ContinuousBatcher over
    ``eng``, ``tokens`` each: (outputs, wall s, decode_metrics
    snapshot)."""
    from deeplearning4j_tpu_torch.runtime.metrics import decode_metrics
    from deeplearning4j_tpu_torch.serving.decode import ContinuousBatcher

    decode_metrics.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with ContinuousBatcher(eng, default_max_tokens=tokens) as cb:
        handles = [cb.submit(p, max_tokens=tokens, temperature=t,
                             seed=s) for p, t, s in reqs]
        outs = [h.result(timeout=600) for h in handles]
    wall = time.perf_counter() - t0
    for o in outs:
        check(o.shape == (tokens,), f"burst output shape {o.shape}")
        check(bool(((o >= 0) & (o < eng.cfg.vocab_size)).all()),
              "burst token out of the vocabulary")
    check(eng.n_active() == 0 and all(
        b.free_slot() == 0 for b in eng._buckets.values()),
        "slots not all free after the burst")
    return outs, wall, decode_metrics.snapshot()


def solo_generate(torch, gpt, cfg, params, eng, p, temp, seed,
                  return_logits=False):
    """One request alone through generate, in its engine bucket's
    cache length."""
    return gpt.generate(cfg, params, torch.from_numpy(p[None]).to(
        GEN_DEVICE), BURST_TOKENS, seed=seed, temperature=temp,
        max_len=eng.pick_bucket(p.size + BURST_TOKENS),
        return_logits=return_logits)


def busy_share_cuda(torch, run):
    """(device busy ms, wall ms) of ``run``: torch.profiler with device
    activity only, summed over the raw trace events (a burst launches
    ~10^5 kernels, too many to turn into profiler function events)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    busy = sum(e.duration_ns()
               for e in prof.profiler.kineto_results.events()
               if e.device_type() == cuda) / 1e6
    return busy, wall


def decode_step_profile(torch, cfg, eng, say) -> None:
    """Host and device time of one decode step with every slot of the
    largest bucket active (prompts of 512, budgets of 64)."""
    bucket = eng.buckets[-1]
    rng = np.random.default_rng(9)
    placed = [eng.start(rng.integers(0, cfg.vocab_size, BURST_MAX),
                        max_tokens=BURST_TOKENS, temperature=BURST_TEMP,
                        seed=i)[:2] for i in range(GEN_SLOTS)]
    check(all(b == bucket for b, _ in placed), "profile slots off-bucket")
    for _ in range(3):
        eng.advance(bucket)
    host = []
    for _ in range(10):
        t0 = time.perf_counter()
        eng.advance(bucket)
        host.append((time.perf_counter() - t0) * 1e3)
    by, _ = profile_kernels(torch, lambda: eng.advance(bucket))
    for b, s in placed:
        eng.release(b, s)
    dev_ms = sum(ms for ms, _ in by.values())
    n_kernels = sum(n for _, n in by.values())
    kv = 2 * cfg.n_layers * GEN_SLOTS * bucket * cfg.hidden * 2
    weights = 2 * (12 * cfg.n_layers * cfg.hidden ** 2
                   + cfg.vocab_size * cfg.hidden)
    bound = (kv + weights) / PEAK_BYTES_PER_S * 1e3
    say(f"(b) one decode step, {GEN_SLOTS} slots active in bucket {bucket}: "
        f"host {np.median(host):.3f} ms (median of 10, synchronized by the "
        f"token fetch), device {dev_ms:.3f} ms in {n_kernels} kernels "
        f"(profiler; {dev_ms / np.median(host):.1%} busy); bound "
        f"{bound:.3f} ms ({(kv + weights) / 1e6:.0f} MB of bf16 weights "
        f"and KV at {PEAK_BYTES_PER_S / 1e12:.2f} TB/s)")
    for key, (ms, n) in sorted(by.items(), key=lambda kv: -kv[1][0])[:6]:
        say(f"    {ms:8.3f} ms  {n:4d}x  {key[:90]}")


def continuous_batching(torch, gpt, cfg, params, reqs, say):
    """(b) the burst through DecodeEngine(n_slots=8) + ContinuousBatcher:
    bf16 timed and profiled, fp32 greedy parity with solo generate,
    sampled requests resubmitted alone, the burst again as sequential
    solo generate calls.  Returns the bf16 outputs."""
    from deeplearning4j_tpu_torch.serving.decode import (
        DecodeEngine, default_length_buckets)

    ladder = default_length_buckets(cfg.max_len)
    eng = DecodeEngine(cfg, params, n_slots=GEN_SLOTS, buckets=ladder,
                       device=GEN_DEVICE)
    w = eng.warmup()
    say(f"(b) DecodeEngine: {GEN_SLOTS} slots, buckets {list(ladder)}, "
        f"prefill chunk {eng.prefill_chunk}, warmup {w['warmup_ms']:.1f} "
        f"ms; kv_bytes_per_slot {eng.kv_bytes_per_slot} "
        f"({eng.kv_bytes_per_slot / 2 ** 20:.1f} MiB, bucket {ladder[-1]})")
    torch.cuda.reset_peak_memory_stats()
    outs, wall, snap = serve_burst(torch, eng, reqs)
    n_tok = BURST * BURST_TOKENS
    say(f"(b) bf16 burst of {BURST} requests (prompts {BURST_MIN}-"
        f"{BURST_MAX}, {BURST_TOKENS} tokens each, half sampled at "
        f"{BURST_TEMP}): {wall:.3f} s, {n_tok / wall:.1f} tokens/s; TTFT "
        f"p50 {snap['ttft_p50_ms']:.2f} ms p99 {snap['ttft_p99_ms']:.2f} "
        f"ms; per-step latency p50 {snap['tok_p50_ms']:.2f} ms p99 "
        f"{snap['tok_p99_ms']:.2f} ms; {snap['decode_dispatches']} decode "
        f"steps, {snap['prefill_dispatches']} prefill chunks, "
        f"{snap['joins']} mid-flight joins, slot occupancy "
        f"{snap['slot_occupancy']:.3f}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    check(snap["joins"] > 0, "no request joined mid-flight")
    check(snap["requests_completed"] == BURST, "burst incomplete")

    # the burst's first requests as sequential solo generate calls
    # (bench.py's decode_serving comparison)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seq = [solo_generate(torch, gpt, cfg, params, eng, p, t, s)
           for p, t, s in reqs[:SOLO_REQS]]
    torch.cuda.synchronize()
    seq_wall = time.perf_counter() - t0
    seq_tps = SOLO_REQS * BURST_TOKENS / seq_wall
    same = sum(int(np.array_equal(o, q[0].cpu().numpy()))
               for o, q in zip(outs, seq))
    say(f"(b) the burst's first {SOLO_REQS} requests as sequential solo "
        f"generate calls: {seq_wall:.3f} s, {seq_tps:.1f} tokens/s; "
        f"continuous batching {n_tok / wall / seq_tps:.2f}x its tokens/s; "
        f"{same}/{SOLO_REQS} requests token-identical (bf16, printed, not "
        f"held)")

    # sampled requests resubmitted alone reproduce bit for bit
    t0 = time.perf_counter()
    sampled = [i for i, (_, t, _) in enumerate(reqs) if t > 0]
    alone = serve_burst(torch, eng, [reqs[sampled[0]]])[0]
    for i in sampled[1:]:
        alone += serve_burst(torch, eng, [reqs[i]])[0]
    diff = [i for i, a in zip(sampled, alone) if not np.array_equal(
        a, outs[i])]
    say(f"(b) {len(sampled)} sampled requests resubmitted alone: "
        f"{len(sampled) - len(diff)} token-identical to their burst run "
        f"({time.perf_counter() - t0:.1f} s)")
    check(not diff, f"sampled requests {diff} changed when resubmitted "
                    f"alone")

    t0 = time.perf_counter()
    decode_step_profile(torch, cfg, eng, say)
    t1 = time.perf_counter()
    busy, wall_ms = busy_share_cuda(torch, lambda: serve_burst(
        torch, eng, reqs))
    say(f"(b) profiled burst: device busy {busy:.1f} ms of {wall_ms:.1f} "
        f"ms wall ({busy / wall_ms:.1%}; torch.profiler, device activity "
        f"only); the step profile took {t1 - t0:.1f} s, this "
        f"{time.perf_counter() - t1:.1f} s")
    del eng

    # fp32 greedy parity: each greedy request in the busy batch matches
    # its solo generate up to the solo run's first step of top-2 margin
    # below PARITY_MARGIN
    t0 = time.perf_counter()
    c32 = dataclasses.replace(cfg, compute_dtype="float32")
    eng32 = DecodeEngine(c32, params, n_slots=GEN_SLOTS, buckets=ladder,
                         device=GEN_DEVICE)
    eng32.warmup()
    outs32, wall32, snap32 = serve_burst(torch, eng32, reqs)
    held = total = cut = 0
    for i, (p, t, s) in enumerate(reqs):
        if t > 0:
            continue
        toks, logits = solo_generate(torch, gpt, c32, params, eng32, p, t,
                                     s, return_logits=True)
        low = (top2_margin(torch, logits[0]) < PARITY_MARGIN).nonzero()
        n = int(low[0, 0]) if low.numel() else BURST_TOKENS
        cut += int(n < BURST_TOKENS)
        check(np.array_equal(outs32[i][:n], toks[0, :n].cpu().numpy()),
              f"fp32 greedy request {i} differs from its solo generate "
              f"within its first {n} tokens")
        held += n
        total += BURST_TOKENS
    say(f"(b) fp32 burst: {wall32:.3f} s, {n_tok / wall32:.1f} tokens/s, "
        f"{snap32['joins']} joins; greedy parity with solo generate held "
        f"over {held}/{total} tokens of {BURST // 2} requests ({cut} cut "
        f"at a step of top-2 margin < {PARITY_MARGIN}); "
        f"{time.perf_counter() - t0:.1f} s in all")
    del eng32
    return outs


def int8_against_cpu(torch, gpt, qz, updaters, cfg, params, say) -> None:
    """The reference's int8 bars on the card against the port's CPU:
    every quantized leaf's round trip within scale / 2 and its payload
    equal to the CPU's but for ones at rounding boundaries
    (test_serving_tier2.py:70); prefill logits through int8 weights and
    the int8 KV cache within KV_DRIFT of the CPU's (:204)."""
    from deeplearning4j_tpu_torch.models import transformer as tfm

    cdt = tfm.compute_dtype(cfg)
    with torch.inference_mode():
        q_card = qz.quantize_tree(params, "int8")
        cpu_params = updaters.tree_map(lambda t: t.cpu(), params)
        q_cpu = qz.quantize_tree(cpu_params, "int8")
        worst_rt, off, n = 0.0, 0, 0
        for grp in params:
            for name, leaf in q_card[grp].items():
                if not isinstance(leaf, qz.QTensor):
                    continue
                sb = leaf.scale.reshape(qz._scale_bshape(leaf.q.ndim,
                                                         leaf.scale))
                rt = ((qz.dequantize_leaf(leaf) - params[grp][name]).abs()
                      / sb).max().item()
                worst_rt = max(worst_rt, rt)
                d = (leaf.q.cpu().int() - q_cpu[grp][name].q.int()).abs()
                check(int(d.max()) <= 1, f"int8 {grp}/{name}: card and "
                                         f"CPU payloads differ by {d.max()}")
                off += int((d > 0).sum())
                n += d.numel()
        check(worst_rt <= 0.5 + 1e-5, f"int8 round trip {worst_rt} scales")
        check(off <= 1e-3 * n, f"int8 payloads: {off} of {n} off by one")
        prompt = torch.from_numpy(np.random.default_rng(11).integers(
            0, cfg.vocab_size, (1, GEN_PROMPT_LEN)).astype(np.int32))
        logits = []
        for tree, dev in ((q_card, GEN_DEVICE), (q_cpu, "cpu")):
            cache = gpt.init_cache(cfg, 1, GEN_PROMPT_LEN, "int8", dev)
            logits.append(gpt._prefill_chunk(
                cfg, qz.dequantize_tree(tree, cdt), cache, prompt.to(dev),
                0)[1].cpu())
    err = (logits[0] - logits[1]).abs().max().item()
    scale = max(logits[1].abs().max().item(), 1.0)
    say(f"(c) int8 on the card vs the port's CPU: round trip <= "
        f"{worst_rt:.6f} scales (bar 0.5), payloads off by one at {off} "
        f"of {n}; int8 weights + int8 KV prefill logits of a "
        f"{GEN_PROMPT_LEN}-token prompt max|diff| {err:.3e} (bar "
        f"{KV_DRIFT} x {scale:.3f})")
    check(err <= KV_DRIFT * scale, f"int8 logits card vs CPU {err}")


def quantized_serving(torch, gpt, cfg, params, reqs, base, say) -> None:
    """(c) the burst with quantize="int8", kv_dtype="int8" and with
    quantize="bf16": tokens/s, kv_bytes_per_slot, greedy agreement with
    full precision, the dequantization's device ms a dispatch."""
    from deeplearning4j_tpu_torch.models import transformer as tfm
    from deeplearning4j_tpu_torch.ops import updaters
    from deeplearning4j_tpu_torch.runtime import quantize as qz
    from deeplearning4j_tpu_torch.serving.decode import (
        DecodeEngine, default_length_buckets)

    t0 = time.perf_counter()
    int8_against_cpu(torch, gpt, qz, updaters, cfg, params, say)
    say(f"(c) int8 against the CPU took {time.perf_counter() - t0:.1f} s")
    cdt = tfm.compute_dtype(cfg)
    for mode, kv in (("int8", "int8"), ("bf16", None)):
        eng = DecodeEngine(cfg, params, n_slots=GEN_SLOTS,
                           buckets=default_length_buckets(cfg.max_len),
                           quantize=mode, kv_dtype=kv, device=GEN_DEVICE)
        eng.warmup()
        outs, wall, snap = serve_burst(torch, eng, reqs)
        qp = eng.current_params()
        deq_ms = time_ms(torch, lambda: qz.dequantize_tree(qp, cdt),
                         iters=10)
        lead = []
        for i, (_, t, _) in enumerate(reqs):
            if t > 0:
                continue
            d = np.nonzero(outs[i] != base[i])[0]
            lead.append(int(d[0]) if d.size else BURST_TOKENS)
        say(f"(c) quantize={mode} kv_dtype={kv}: {wall:.3f} s, "
            f"{BURST * BURST_TOKENS / wall:.1f} tokens/s; "
            f"kv_bytes_per_slot {eng.kv_bytes_per_slot} "
            f"({eng.kv_bytes_per_slot / 2 ** 20:.1f} MiB); weights "
            f"{qz.tree_bytes(qp) / 1e6:.1f} MB; dequantization "
            f"{deq_ms:.4f} ms a dispatch (CUDA events); greedy tokens "
            f"equal to full precision's up to the first difference: "
            f"{sum(lead)}/{len(lead) * BURST_TOKENS} ({sum(x == BURST_TOKENS for x in lead)}/{len(lead)} "
            f"requests whole); TTFT p50 {snap['ttft_p50_ms']:.2f} ms, "
            f"per-step p50 {snap['tok_p50_ms']:.2f} ms")
        del eng


def gpt_scoring(torch, fa, gpt, cfg, params, say) -> int:
    """(d) GPT scoring through InferenceEngine(gpt.make_serving_apply) at
    T=1024 causal, buckets 1/2/4: logits within the bar of the
    plain-attention forward, B1 launched once per layer per dispatch;
    one more row through InferenceEngine(quantize="int8"), held to the
    plain-attention forward of the dequantized tree.  Returns the B1 launches of the counted
    dispatches."""
    from deeplearning4j_tpu_torch.models import transformer as tfm
    from deeplearning4j_tpu_torch.runtime import quantize as qz
    from deeplearning4j_tpu_torch.serving.engine import InferenceEngine

    apply_fn = gpt.make_serving_apply(cfg)
    eng = InferenceEngine(apply_fn, params, buckets=SCORING_BUCKETS,
                          device=GEN_DEVICE)
    w = eng.warmup(input_shape=(SCORING_T,), dtype=np.int32)
    q8 = InferenceEngine(apply_fn, params, buckets=(1,), quantize="int8",
                         device=GEN_DEVICE)
    q8.warmup(input_shape=(SCORING_T,), dtype=np.int32)
    rng = np.random.default_rng(12)
    reqs = [rng.integers(0, cfg.vocab_size, (n, SCORING_T)).astype(np.int32)
            for n in SCORING_ROWS]
    fa.reset_launches()
    t0 = time.perf_counter()
    outs = [eng.infer(x, sync=True) for x in reqs]
    sec = time.perf_counter() - t0
    q_out = q8.infer(reqs[0], sync=True)
    launches = fa.launch_counts()
    n_disp = len(reqs) + 1
    plain = gpt.make_serving_apply(cfg, attn_fn=tfm.attention)
    with torch.inference_mode():
        x0 = torch.from_numpy(reqs[0]).to(GEN_DEVICE)
        q_ref = plain(qz.dequantize_tree(q8.current_params()), x0)
        q_err = (q_out - q_ref).abs().max().item()
        q_ok = torch.allclose(q_out, q_ref, rtol=LOGITS_TOL, atol=LOGITS_TOL)
        del q_ref
    q_far = (q_out - outs[0]).abs().max().item()
    say(f"(d) InferenceEngine(quantize=\"int8\"), 1 row: max|diff| vs the "
        f"plain-attention forward of the dequantized tree {q_err:.3e} "
        f"(tolerance {LOGITS_TOL}), vs full precision {q_far:.3e}")
    check(q_ok, f"int8 scoring differs from the plain-attention forward of "
                f"the dequantized tree by {q_err}")
    check(q_far > 1e-3, "int8 scoring equals full precision: not quantized")
    err = 0.0
    with torch.inference_mode():
        for x, got in zip(reqs, outs):
            check(got.shape == (x.shape[0], SCORING_T, cfg.vocab_size),
                  f"scoring shape {tuple(got.shape)}")
            check(bool(torch.isfinite(got).all()), "scoring non-finite")
            ref = plain(params, torch.from_numpy(x).to(GEN_DEVICE))
            e = (got - ref).abs().max().item()
            err = max(err, e)
            check(torch.allclose(got, ref, rtol=LOGITS_TOL, atol=LOGITS_TOL),
                  f"scoring logits differ from the plain forward by {e}")
            del ref
    say(f"(d) GPT scoring at T={SCORING_T} causal, buckets "
        f"{list(SCORING_BUCKETS)} (warmup {w['warmup_ms']:.1f} ms): "
        f"{len(reqs)} requests of {list(SCORING_ROWS)} rows in {sec:.3f} s "
        f"(host clock, synchronized; {sum(SCORING_ROWS) * SCORING_T / sec:.1f} "
        f"tokens/s); max|diff| vs the plain-attention forward {err:.3e} "
        f"(tolerance {LOGITS_TOL}); B1 launches {launches['launches']} "
        f"({cfg.n_layers} layers x {n_disp} dispatches, the int8 one "
        f"included)")
    check(launches["launches"] == cfg.n_layers * n_disp,
          f"B1 launched {launches['launches']} times for {n_disp} "
          f"scoring dispatches")
    check(launches["launches_dkv"] == launches["launches_dq"] == 0,
          "a backward kernel ran while scoring")
    return launches["launches"]


def generation_phase(torch, fa, card: str) -> int:
    """Phase 10 (see the module docstring).  Returns B1's launches."""
    from deeplearning4j_tpu_torch.models import gpt

    def say(msg):
        print(f"  {msg} [{card}]")

    cfg = gen_config(gpt)
    gen = torch.Generator(device=GEN_DEVICE)
    gen.manual_seed(0)
    params = gpt.init_params(gen, cfg, device=GEN_DEVICE)
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    reqs = burst_requests(cfg)
    t0 = time.perf_counter()
    decode_against_dense(torch, gpt, cfg, params, say)
    t1 = time.perf_counter()
    base = continuous_batching(torch, gpt, cfg, params, reqs, say)
    t2 = time.perf_counter()
    quantized_serving(torch, gpt, cfg, params, reqs, base, say)
    t3 = time.perf_counter()
    hand = fa.launch_counts()
    check(not any(hand.values()), f"flash kernels ran on the decode "
                                  f"path: {hand}")
    n = gpt_scoring(torch, fa, gpt, cfg, params, say)
    say(f"phase 10 wall: (a) {t1 - t0:.1f} s, (b) {t2 - t1:.1f} s, (c) "
        f"{t3 - t2:.1f} s, (d) {time.perf_counter() - t3:.1f} s")
    return n

# ---------------------------------------------------------------------------
# phase 11: the compile engine's CUDA graphs against the raw functions
# ---------------------------------------------------------------------------

#: captured against eager, each bar with its reason: LeNet fp32 runs the
#: same kernels in both (cuDNN deterministic for both); the transformer
#: steps (bf16 with dropout) ran bit-equal captured and eager, so the
#: loss and the parameters' change from the initial state (p_k - p_0) are
#: held at 1e-6 relative, a bar that a frozen AdamW count or frozen
#: dropout masks fail by orders of magnitude; decode logits fp32 / bf16;
#: B4 and B5 sum a row's hits with atomics in no fixed order
GRAPH_LENET_RTOL = 1e-6
GRAPH_TRAIN_RTOL = 1e-6
GRAPH_DECODE_TOL = {"float32": 1e-5, "bfloat16": 5e-2}
GRAPH_EMBED_RTOL = 1e-4
GRAPH_LENET_STEPS, GRAPH_TRAIN_STEPS, GRAPH_DECODE_STEPS = 20, 10, 8
GRAPH_TIMED = {"lenet": 30, "train": 5, "decode": 20}


@contextlib.contextmanager
def eager_engine():
    """Every compile-engine entry runs its raw function (``call.fn``):
    the eager comparator, nothing captured or counted."""
    from deeplearning4j_tpu_torch.runtime import compile_cache

    call = compile_cache.GraphFn.__call__
    compile_cache.GraphFn.__call__ = lambda self, *a, **kw: self.fn(*a, **kw)
    try:
        yield
    finally:
        compile_cache.GraphFn.__call__ = call


def host_ms(torch, run, n: int) -> float:
    """Median host ms of ``n`` calls of ``run``, each synchronized."""
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out))


def device_ms(torch, run, n: int):
    """(device ms, kernels) a call of ``run`` over ``n`` profiled calls
    (torch.profiler); (None, 0) when it reports no device time."""
    by, _ = profile_kernels(torch, lambda: [run() for _ in range(n)])
    if not by:
        return None, 0
    return (sum(ms for ms, _ in by.values()) / n,
            sum(k for _, k in by.values()) / n)


def graph_times(torch, what, runs, n_host, n_dev, say):
    """Host ms, device ms and busy share of each of ``runs`` ({"eager":
    fn, "captured": fn}), printed side by side."""
    rows = {}
    for how, run in runs.items():
        h = host_ms(torch, run, n_host)
        d, k = device_ms(torch, run, n_dev)
        rows[how] = (h, d, k)
    parts = []
    for how, (h, d, k) in rows.items():
        dev = ("device not measured" if d is None else
               f"device {d:.3f} ms in {k:.0f} kernels = {d / h:.1%} busy")
        parts.append(f"{how} host {h:.3f} ms, {dev}")
    say(f"{what}: " + "; ".join(parts)
        + f" (host: median of {n_host} synchronized calls; device: "
          f"profiler over {n_dev})")
    return rows


def graph_lenet(torch, ln, entries, say) -> None:
    """LeNet fp32 B=128: 20 steps through the raw step and through its
    graph from the same state and batches."""
    from deeplearning4j_tpu_torch.runtime.metrics import compile_metrics

    net = lenet_net(ln, "float32", ln.lenet(device="cpu").params, "cuda")
    step = net._machinery()[0]
    entries.append(step)
    batches = [(torch.as_tensor(b.features).cuda(),
                torch.as_tensor(b.labels).cuda())
               for b in lenet_random_batches(GRAPH_LENET_STEPS, seed=3)]
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        res, runs = {}, {}
        for how, fn in (("eager", step.fn), ("captured", step)):
            params, ustate, it, gen = net._fit_state(2)
            state = (params, ustate, it)
            losses = []
            for k, (x, y) in enumerate(batches):
                if k == 1:
                    c1 = compile_metrics.compile_count
                *state, loss, _ = fn(*state, x, y, gen)
                losses.append(float(loss))
            res[how] = (np.array(losses), state[0])
            if how == "captured":
                delta = compile_metrics.compile_count - c1
            runs[how] = (lambda fn=fn, st=state, g=gen: fn(
                *st, *batches[0], g))
        lrel = float(np.max(np.abs(res["captured"][0] - res["eager"][0])
                            / np.abs(res["eager"][0])))
        prel = max(float((c[k] - e[k]).abs().max() / e[k].abs().max())
                   for c, e in zip(res["captured"][1], res["eager"][1])
                   for k in e)
        say(f"LeNet fp32 B={LENET_B}, {GRAPH_LENET_STEPS} steps captured vs "
            f"eager (cuDNN deterministic for both): losses' largest relative "
            f"difference {lrel:.3e}, parameters' {prel:.3e} (bar "
            f"{GRAPH_LENET_RTOL:g}); captures over steps 2-"
            f"{GRAPH_LENET_STEPS}: {delta}")
        check(lrel <= GRAPH_LENET_RTOL and prel <= GRAPH_LENET_RTOL,
              f"LeNet: captured steps differ from eager ({lrel}, {prel})")
        check(delta == 0, f"LeNet: {delta} captures in the steady state")
        graph_times(torch, f"LeNet fp32 step B={LENET_B}", runs,
                    GRAPH_TIMED["lenet"], 10, say)
        del runs, res, state
        lenet_threads(torch, ln, say)
    finally:
        torch.backends.cudnn.deterministic = det


def lenet_threads(torch, ln, say) -> None:
    """Two LeNet networks of one conf fit at once, in two threads,
    through their shared ``multilayer.train_step``, in lockstep (a
    listener holds each step until the other thread's same step is
    done): each must end where its solo eager fit ends."""
    from deeplearning4j_tpu_torch.runtime.metrics import compile_metrics

    batches = lenet_random_batches(GRAPH_LENET_STEPS, seed=5)
    last = batches[-1]
    # a ragged last batch: the per-step path, which calls the listeners
    # after every step
    batches[-1] = type(last)(last.features[:LENET_B // 2],
                             last.labels[:LENET_B // 2])
    inits = [ln.lenet(seed=s, device="cpu").params for s in (7, 8)]
    solo = []
    with eager_engine():
        for p in inits:
            net = lenet_net(ln, "float32", p, "cuda")
            net.fit_backprop(batches)
            solo.append(net.params_flat())
    lockstep = threading.Barrier(2, timeout=120)

    class Lockstep:
        def iteration_done(self, net, n, score):
            lockstep.wait()

    nets = [lenet_net(ln, "float32", p, "cuda") for p in inits]
    for net in nets:
        net.set_listeners([Lockstep()])
    c0 = compile_metrics.compile_count
    errors = []

    def fit(net):
        try:
            net.fit_backprop(batches)
        except Exception as e:          # reported below
            lockstep.abort()
            errors.append(e)

    threads = [threading.Thread(target=fit, args=(n,)) for n in nets]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    check(not any(t.is_alive() for t in threads) and not errors,
          f"LeNet threads: {errors}")
    caps = compile_metrics.compile_count - c0
    rels = [float((n.params_flat() - r).abs().max() / r.abs().max())
            for n, r in zip(nets, solo)]
    say(f"two same-conf LeNet fits ({GRAPH_LENET_STEPS} steps each, the "
        f"last batch {LENET_B // 2} rows) in two threads, in lockstep "
        f"through one shared train step, against each one's solo eager "
        f"fit: parameters' largest relative difference {rels[0]:.3e} and "
        f"{rels[1]:.3e} (bar {GRAPH_LENET_RTOL:g}); captures: {caps} (the "
        f"second live state's set, and the short batch on each set)")
    check(max(rels) <= GRAPH_LENET_RTOL,
          f"LeNet threads differ from their solo fits {rels}")
    check(caps >= 2, f"LeNet threads: {caps} captures, so the two fits "
                     f"did not run on two state sets at once")


def update_rel(torch, updaters, p0, got, ref) -> float:
    """Relative L2 of the parameters' change from ``p0``: ``|(got - p0)
    - (ref - p0)| / |ref - p0|`` over every leaf."""
    num = den = 0.0
    for a, c, e in zip(updaters.tree_leaves(p0), updaters.tree_leaves(got),
                       updaters.tree_leaves(ref)):
        d = e.double() - a.double()
        num += float((c.double() - e.double()).norm()) ** 2
        den += float(d.norm()) ** 2
    return (num / den) ** 0.5


def graph_train(torch, mod, cfg, batch, what, entries, say,
                interleave: bool = False) -> None:
    """A transformer step, bf16 with dropout: 10 steps through the raw
    step and through its graph from the same state and generator seed;
    with ``interleave``, two states stepped alternately through one
    ``step_fn``, each against its solo eager run."""
    from deeplearning4j_tpu_torch.ops import updaters
    from deeplearning4j_tpu_torch.runtime.metrics import compile_metrics

    init_fn, step_fn = mod.make_train_step(cfg)
    graph = step_fn.graph
    entries.append(graph)
    s0 = init_fn(torch.Generator(device="cuda").manual_seed(0))
    res, runs = {}, {}
    for how, fn in (("eager", graph.fn), ("captured", graph)):
        # the raw step writes its state in place: it runs on a copy
        st = updaters.tree_map(torch.clone, (s0.params, s0.opt_state))
        gen = torch.Generator(device="cuda").manual_seed(1)
        losses = []
        for k in range(GRAPH_TRAIN_STEPS):
            if k == 1:
                c1 = compile_metrics.compile_count
            *st, loss = fn(*st, batch, gen)
            losses.append(float(loss))
        res[how] = (np.array(losses), st[0])
        if how == "captured":
            delta = compile_metrics.compile_count - c1
        runs[how] = lambda fn=fn, st=st, g=gen: fn(*st, batch, g)
    lrel = float(np.max(np.abs(res["captured"][0] - res["eager"][0])
                        / np.abs(res["eager"][0])))
    urel = update_rel(torch, updaters, s0.params, res["captured"][1],
                      res["eager"][1])
    say(f"{what}, {GRAPH_TRAIN_STEPS} steps captured vs eager (bf16, "
        f"dropout {cfg.dropout}): losses " + " / ".join(
            f"{a:.4f}:{b:.4f}" for a, b in zip(res["eager"][0],
                                               res["captured"][0]))
        + f"; largest relative loss difference {lrel:.3e}, relative L2 "
          f"of the parameters' change p_k - p_0 {urel:.3e} (bar "
          f"{GRAPH_TRAIN_RTOL:g}); captures over steps 2-"
          f"{GRAPH_TRAIN_STEPS}: {delta}")
    check(lrel <= GRAPH_TRAIN_RTOL and urel <= GRAPH_TRAIN_RTOL,
          f"{what}: captured steps differ from eager ({lrel}, {urel})")
    check(delta == 0, f"{what}: {delta} captures in the steady state")
    graph_times(torch, f"{what} step", runs, GRAPH_TIMED["train"], 2, say)
    del runs, res, st
    if interleave:
        graph_interleave(torch, updaters, init_fn, step_fn, batch, what,
                         say)


def graph_interleave(torch, updaters, init_fn, step_fn, batch, what,
                     say) -> None:
    """Two training states stepped alternately through one ``step_fn``
    (``a1 = f(a0); b1 = f(b0); a2 = f(a1)``, ...): each must end where
    its solo eager run ends, and the initial states must not change."""
    from deeplearning4j_tpu_torch.runtime.metrics import compile_metrics

    n = 3
    inits = [init_fn(torch.Generator(device="cuda").manual_seed(s))
             for s in (2, 3)]
    kept = [updaters.tree_map(torch.clone, s.params) for s in inits]
    solo = []
    with eager_engine():
        for k, s in enumerate(inits):
            st = s._replace(params=updaters.tree_map(torch.clone, s.params),
                            opt_state=updaters.tree_map(torch.clone,
                                                        s.opt_state))
            gen = torch.Generator(device="cuda").manual_seed(10 + k)
            for _ in range(n):
                st, _ = step_fn(st, batch, gen)
            solo.append(st.params)
            del st
    c0 = compile_metrics.compile_count
    st = list(inits)
    gens = [torch.Generator(device="cuda").manual_seed(10 + k)
            for k in (0, 1)]
    for _ in range(n):
        for k in (0, 1):
            st[k], _ = step_fn(st[k], batch, gens[k])
    rels = [update_rel(torch, updaters, kept[k], st[k].params, solo[k])
            for k in (0, 1)]
    same0 = all(torch.equal(a, b) for k in (0, 1) for a, b in zip(
        updaters.tree_leaves(kept[k]), updaters.tree_leaves(inits[k].params)))
    caps = compile_metrics.compile_count - c0
    say(f"{what}: two states stepped alternately through one step_fn, "
        f"{n} steps each, against each one's solo eager run: relative L2 "
        f"of the change p_k - p_0 {rels[0]:.3e} and {rels[1]:.3e} (bar "
        f"{GRAPH_TRAIN_RTOL:g}); initial states unchanged: {same0}; "
        f"captures: {caps} (a state set each for two live states)")
    check(max(rels) <= GRAPH_TRAIN_RTOL,
          f"{what}: interleaved states differ from their solo runs {rels}")
    check(same0, f"{what}: a step wrote the caller's initial state")


def graph_decode(torch, gpt, entries, say) -> None:
    """GPT-2 small decoding: slot_decode's logits captured vs eager (8
    slots, bucket 1024, bf16 and fp32), then the engine's decode step
    and the 32-request burst with its entries captured and raw."""
    from deeplearning4j_tpu_torch.ops import updaters
    from deeplearning4j_tpu_torch.runtime import compile_cache
    from deeplearning4j_tpu_torch.runtime import quantize as qz
    from deeplearning4j_tpu_torch.runtime.metrics import compile_metrics
    from deeplearning4j_tpu_torch.serving.decode import (
        DecodeEngine, default_length_buckets)

    cfg = gen_config(gpt)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = gpt.init_params(gen, cfg, device="cuda")
    rng = np.random.default_rng(11)
    T, C = cfg.max_len, gpt.PREFILL_CHUNK
    with torch.inference_mode():
        for c in (cfg, dataclasses.replace(cfg, compute_dtype="float32")):
            sp = gpt.serving_params(c, params)
            slots = gpt.init_slots(c, GEN_SLOTS, T, device="cuda")
            for s in range(GEN_SLOTS):
                toks = torch.from_numpy(rng.integers(
                    0, c.vocab_size, BURST_MAX).astype(np.int32)).cuda()
                for lo in range(0, BURST_MAX, C):
                    gpt.slot_prefill(c, sp, slots, toks[lo:lo + C], s, lo,
                                     C, 0.0, s)
            active = torch.ones(GEN_SLOTS, dtype=torch.bool, device="cuda")
            temps = torch.tensor([0.0, BURST_TEMP] * (GEN_SLOTS // 2),
                                 device="cuda")
            seeds = torch.arange(GEN_SLOTS, dtype=torch.int64,
                                 device="cuda")

            def fn(p, sl, a, t, sd, c=c):
                return gpt.slot_decode(c, p, sl, a, t, sd,
                                       return_logits=True)

            g = compile_cache.cached_graph(fn, label="slot_decode.logits",
                                           donate_argnums=(1,))
            entries.append(g)
            se = updaters.tree_map(torch.clone, slots)
            sc = updaters.tree_map(torch.clone, slots)
            worst, same = 0.0, 0
            for _ in range(GRAPH_DECODE_STEPS):
                _, te, le = fn(sp, se, active, temps, seeds)
                sc, tc, lc = g(sp, sc, active, temps, seeds)
                worst = max(worst, float((le - lc).abs().max()))
                same += int(torch.equal(te, tc))
            bar = GRAPH_DECODE_TOL[c.compute_dtype]
            say(f"slot_decode {c.compute_dtype}, {GEN_SLOTS} slots at "
                f"position {BURST_MAX}+ of bucket {T}: captured vs eager "
                f"logits max|diff| {worst:.3e} over {GRAPH_DECODE_STEPS} "
                f"steps (bar {bar:g}); tokens identical at {same}/"
                f"{GRAPH_DECODE_STEPS} steps")
            check(worst <= bar, f"slot_decode {c.compute_dtype}: captured "
                                f"logits differ from eager by {worst}")
            del slots, se, sc, g

    ladder = default_length_buckets(cfg.max_len)
    eng = DecodeEngine(cfg, params, n_slots=GEN_SLOTS, buckets=ladder,
                       device="cuda")
    entries.extend([eng._prefill, eng._decode])
    w = eng.warmup()
    say(f"DecodeEngine warm-up: {w['compiles']} captures for "
        f"{len(ladder)} buckets (prefill + step each) in "
        f"{w['warmup_ms']:.1f} ms")
    check(w["compiles"] == 2 * len(ladder), "decode warm-up captures != "
                                            "2 x buckets")
    reqs = burst_requests(cfg)
    c0 = compile_metrics.compile_count
    outs, wall, snap = serve_burst(torch, eng, reqs)
    with eager_engine():
        outs_e, wall_e, _ = serve_burst(torch, eng, reqs)
    n_tok = BURST * BURST_TOKENS
    same = sum(int(np.array_equal(a, b)) for a, b in zip(outs, outs_e))
    delta = compile_metrics.compile_count - c0
    say(f"the {BURST}-request burst (bf16): captured {wall:.3f} s = "
        f"{n_tok / wall:.1f} tokens/s, eager {wall_e:.3f} s = "
        f"{n_tok / wall_e:.1f} tokens/s ({wall_e / wall:.2f}x); "
        f"{same}/{BURST} requests token-identical; captures during the "
        f"captured burst: {delta}")
    check(delta == 0, f"decode: {delta} captures in the steady state")

    bucket = ladder[-1]
    placed = [eng.start(rng.integers(0, cfg.vocab_size, BURST_MAX),
                        max_tokens=BURST_TOKENS, temperature=BURST_TEMP,
                        seed=i)[:2] for i in range(GEN_SLOTS)]
    check(all(b == bucket for b, _ in placed), "decode slots off-bucket")

    eng.advance(bucket)             # takes the joins' slot vectors in
    b0 = eng._decode.copied_bytes
    for _ in range(5):
        eng.advance(bucket)
    per_step = (eng._decode.copied_bytes - b0) / 5
    say(f"bytes copied into the graphs' buffers per steady decode step: "
        f"{per_step:.0f} (the served weights, {qz.tree_bytes(eng.current_params())} "
        f"bytes, were copied once, at the warm-up)")
    check(per_step == 0, f"decode: a steady step copies {per_step} bytes")

    def eager_step():
        with eager_engine():
            eng.advance(bucket)

    graph_times(torch, f"GPT-2 small decode step, {GEN_SLOTS} slots in "
                       f"bucket {bucket}",
                {"eager": eager_step,
                 "captured": lambda: eng.advance(bucket)},
                GRAPH_TIMED["decode"], 3, say)
    for b, s in placed:
        eng.release(b, s)
    del eng
    inference_weights(torch, gpt, cfg, params, bucket, entries, rng, say)


def inference_weights(torch, gpt, cfg, params, bucket, entries, rng,
                      say) -> None:
    """The captured decode step with its served weights made under
    ``inference_mode``, as the engine's first design made them: an
    inference tensor has no version counter, so the engine copies it
    into the graph's buffers at every step.  Prints what that costs a
    step beside the main engine's numbers above."""
    from deeplearning4j_tpu_torch.serving.decode import DecodeEngine

    with torch.inference_mode():
        tree = gpt.serving_params(cfg, params)
    eng = DecodeEngine(cfg, tree, n_slots=GEN_SLOTS, buckets=(bucket,),
                       device="cuda")
    entries.extend([eng._prefill, eng._decode])
    eng.warmup()
    for i in range(GEN_SLOTS):
        eng.start(rng.integers(0, cfg.vocab_size, BURST_MAX),
                  max_tokens=BURST_TOKENS, temperature=BURST_TEMP, seed=i)
    eng.advance(bucket)
    b0 = eng._decode.copied_bytes
    for _ in range(5):
        eng.advance(bucket)
    per_step = (eng._decode.copied_bytes - b0) / 5
    h = host_ms(torch, lambda: eng.advance(bucket), GRAPH_TIMED["decode"])
    d, k = device_ms(torch, lambda: eng.advance(bucket), 3)
    dev = ("device not measured" if d is None else
           f"device {d:.3f} ms in {k:.0f} kernels = {d / h:.1%} busy")
    say(f"the same captured decode step with its served weights made under "
        f"inference_mode (no version counter): {per_step:.0f} bytes copied "
        f"in a step; host {h:.3f} ms, {dev}")
    del eng


def graph_embeddings(torch, t8, entries, say) -> None:
    """One word2vec epoch and one GloVe epoch on text8, warm (pairs and
    graphs ready), from the same tables and draws: captured vs eager."""
    from deeplearning4j_tpu_torch.nlp import glove as tglove
    from deeplearning4j_tpu_torch.nlp import word2vec as tw2v
    from deeplearning4j_tpu_torch.nlp.glove import (Glove, GloveConfig,
                                                    count_cooccurrences)
    from deeplearning4j_tpu_torch.nlp.vocab import build_vocab
    from deeplearning4j_tpu_torch.runtime import compile_cache
    from deeplearning4j_tpu_torch.runtime.metrics import compile_metrics

    cfg = tw2v.Word2VecConfig(min_word_frequency=5, epochs=1, **W2V_CONFIG)
    w2v = tw2v.Word2Vec(t8, cfg, device="cuda")
    w2v.fit()                               # pairs, slabs and captures
    entries.append(compile_cache.cached_graph(
        tw2v._pair_chunk, key="word2vec.pair_chunk"))
    init = (w2v.syn0, w2v.syn1, w2v.syn1neg)
    c0 = compile_metrics.compile_count
    tabs, sec, busy = {}, {}, {}
    for how in ("captured", "eager"):
        ctx = eager_engine() if how == "eager" else contextlib.nullcontext()
        with ctx:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            w2v.fit(initial_weights=init)
            torch.cuda.synchronize()
            sec[how] = time.perf_counter() - t0
            tabs[how] = (w2v.syn0, w2v.syn1, w2v.syn1neg)
            busy[how] = busy_share(torch, lambda: w2v.fit(
                initial_weights=init))
    delta = compile_metrics.compile_count - c0
    err, rel = rel_diff(torch, tabs["captured"], tabs["eager"])
    words = w2v._n_positions
    say(f"word2vec text8 epoch ({w2v.chunks} chunks), captured vs eager: "
        f"tables max|diff| {err:.3e}, relative L2 {rel:.3e} (bar "
        f"{GRAPH_EMBED_RTOL:g}); captured {sec['captured']:.3f} s = "
        f"{words / sec['captured']:.1f} words/s, eager {sec['eager']:.3f} "
        f"s = {words / sec['eager']:.1f} words/s; profiled epoch device "
        f"busy captured {busy['captured'][0]:.1f} of "
        f"{busy['captured'][1]:.1f} ms ({busy['captured'][0] / busy['captured'][1]:.1%}), "
        f"eager {busy['eager'][0]:.1f} of {busy['eager'][1]:.1f} ms "
        f"({busy['eager'][0] / busy['eager'][1]:.1%}); captures over the "
        f"warm epochs: {delta}")
    check(rel <= GRAPH_EMBED_RTOL, f"word2vec: captured epoch differs from "
                                   f"eager by {rel}")
    check(delta == 0, f"word2vec: {delta} captures in the steady state")

    gcfg = GloveConfig(epochs=1)
    g = Glove(t8, gcfg, device="cuda")
    g.cache = build_vocab(t8, g.tokenizer, gcfg.min_word_frequency)
    co = count_cooccurrences(t8, g.tokenizer, g.cache, gcfg.window,
                             gcfg.symmetric)
    g.fit(cooccurrences=co)                 # the capture
    entries.append(compile_cache.cached_graph(
        tglove._glove_chunk, key="glove.chunk"))
    c0 = compile_metrics.compile_count
    states, sec, busy = {}, {}, {}
    for how in ("captured", "eager"):
        ctx = eager_engine() if how == "eager" else contextlib.nullcontext()
        one = Glove(t8, gcfg, cache=g.cache, device="cuda")
        with ctx:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            one.fit(initial_weights=g.state, cooccurrences=co)
            torch.cuda.synchronize()
            sec[how] = time.perf_counter() - t0
            states[how] = one.state
            busy[how] = busy_share(torch, lambda: Glove(
                t8, gcfg, cache=g.cache, device="cuda").fit(
                    initial_weights=g.state, cooccurrences=co))
    delta = compile_metrics.compile_count - c0
    err, rel = rel_diff(torch, states["captured"], states["eager"])
    P = co[0].size
    say(f"GloVe text8 epoch ({one.chunks} chunks), captured vs eager: state "
        f"max|diff| {err:.3e}, relative L2 {rel:.3e} (bar "
        f"{GRAPH_EMBED_RTOL:g}); captured {sec['captured']:.3f} s = "
        f"{P / sec['captured']:.1f} triples/s, eager {sec['eager']:.3f} s = "
        f"{P / sec['eager']:.1f} triples/s; profiled epoch device busy "
        f"captured {busy['captured'][0]:.1f} of {busy['captured'][1]:.1f} "
        f"ms ({busy['captured'][0] / busy['captured'][1]:.1%}), eager "
        f"{busy['eager'][0]:.1f} of {busy['eager'][1]:.1f} ms "
        f"({busy['eager'][0] / busy['eager'][1]:.1%}); captures over the "
        f"warm epochs: {delta}")
    check(rel <= GRAPH_EMBED_RTOL, f"GloVe: captured epoch differs from "
                                   f"eager by {rel}")
    check(delta == 0, f"GloVe: {delta} captures in the steady state")


def graph_phase(torch, ln, t8, card: str) -> None:
    """Phase 11 (see the module docstring)."""
    from deeplearning4j_tpu_torch.models import bert, gpt
    from deeplearning4j_tpu_torch.runtime import compile_cache
    from deeplearning4j_tpu_torch.runtime.metrics import compile_metrics

    def say(msg):
        print(f"  {msg} [{card}]")

    compile_cache.clear()
    compile_metrics.reset()
    entries = []
    t0 = time.perf_counter()
    graph_lenet(torch, ln, entries, say)
    t1 = time.perf_counter()
    bcfg = bert.bert_base()
    graph_train(torch, bert, bcfg,
                bert.synthetic_batch(0, bcfg, 32, 128, device="cuda"),
                "BERT-base MLM B=32 T=128", entries, say, interleave=True)
    gcfg = gpt.gpt_config()
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, gcfg.vocab_size, (8, 1024)).astype(np.int32)).cuda()
    graph_train(torch, gpt, gcfg, ids, "GPT-2 small B=8 T=1024 (remat)",
                entries, say)
    t2 = time.perf_counter()
    graph_decode(torch, gpt, entries, say)
    t3 = time.perf_counter()
    graph_embeddings(torch, t8, entries, say)
    t4 = time.perf_counter()
    snap = compile_metrics.snapshot()
    traces = snap["traces"]
    held = {}
    for e in {id(e): e for e in entries}.values():
        if e.signatures():
            held[e.label] = held.get(e.label, 0) + e.signatures()
    say(f"captures per label {traces}; signatures the entries hold {held}; "
        f"{snap['compile_count']} captures took {snap['compile_ms']} ms "
        f"(warm-up runs, capture and first replay); "
        f"{snap['cached_dispatches']} replays")
    check(traces == held, "captures per label != signatures held")
    say(f"phase 11 wall: LeNet {t1 - t0:.1f} s, training {t2 - t1:.1f} s, "
        f"decoding {t3 - t2:.1f} s, embeddings {t4 - t3:.1f} s")


# ---------------------------------------------------------------------------
# phase 12: self-healing training, checkpoints and run telemetry
# ---------------------------------------------------------------------------

#: phase 12's LeNet run: data/mnist at B=128 (16 batches an epoch), the
#: poisoned batch (its first read only), the step the injected detector
#: fires at (in epoch 1, after the step-24 snapshot), the bounded slice
#: and the preemption request
RF_EPOCHS, RF_EVERY = 3, 8
RF_POISON_BATCH, RF_FIRE_CALL, RF_SLICE, RF_PREEMPT_AT = 5, 30, 20, 10
#: GPT-2 small: steps before the snapshot, steps dispatched behind it,
#: steps timed with no snapshot in flight
GPT_SNAP_AT, GPT_BEHIND, GPT_TIMED = 2, 2, 3


class PoisonOnce:
    """A batch whose first read comes back with a NaN (a transient
    fault: a flaky read), every later read clean.  Shared by a bounded
    slice and its resume, it poisons the same step an uninterrupted run
    does (its first visit, in epoch 0)."""

    def __init__(self, ds):
        self._ds = ds
        self.labels = ds.labels
        self.reads = 0

    @property
    def features(self):
        self.reads += 1
        if self.reads > 1:
            return self._ds.features
        x = self._ds.features.clone()
        x.view(-1)[0] = float("nan")
        return x


def fire_once_detector(at: int):
    """A loss-spike detector that reports one sustained anomaly at its
    ``at``-th observation (shared by a slice and its resume, it fires at
    the same step as in an uninterrupted run)."""
    from deeplearning4j_tpu_torch.runtime.resilience import LossSpikeDetector

    class FireOnce(LossSpikeDetector):
        def __init__(self):
            super().__init__()
            self.calls = 0

        def observe(self, loss):
            self.calls += 1
            return self.calls == at

    return FireOnce()


def rf_leaves(tree):
    from deeplearning4j_tpu_torch.runtime.checkpoint import \
        _flatten_with_paths

    return _flatten_with_paths(tree)


def resilient_lenet(torch, ln, tmp, say):
    """Part (a): ResilientFit over LeNet-MNIST (see the module
    docstring).  Returns the telemetry tracer of the run."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.optimize.listeners import IterationListener
    from deeplearning4j_tpu_torch.runtime import resilience, telemetry
    from deeplearning4j_tpu_torch.runtime.metrics import (checkpoint_metrics,
                                                          compile_metrics,
                                                          resilience_metrics)
    from deeplearning4j_tpu_torch.runtime.resilience import (
        PreemptionGuard, ResilienceConfig, ResilientFit)

    train = mnist_split(True)
    clean = [DataSet(torch.as_tensor(b.features).cuda(),
                     torch.as_tensor(b.labels).cuda())
             for b in train.batch_by(LENET_B)]
    steps = RF_EPOCHS * len(clean)
    params0 = ln.lenet(device="cpu").params

    def data():
        return [PoisonOnce(b) if i == RF_POISON_BATCH else b
                for i, b in enumerate(clean)]

    def run(name, batches, detector, **kw):
        net = lenet_net(ln, "bfloat16", params0, "cuda")
        drv = ResilientFit(net, ResilienceConfig(
            checkpoint_dir=os.path.join(tmp, name),
            checkpoint_every=RF_EVERY, max_to_keep=10, **kw),
            detector=detector)
        resilience_metrics.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        drv.fit(batches, num_epochs=RF_EPOCHS, seed=5)
        torch.cuda.synchronize()
        return net, drv, time.perf_counter() - t0, \
            resilience_metrics.snapshot()

    # warm-up: the train step's capture and the restore check's
    warm = lenet_net(ln, "bfloat16", params0, "cuda")
    warm.fit_backprop(clean[0])
    check(resilience.compiled_all_finite(warm.params), "warm-up params")
    del warm
    c0 = compile_metrics.compile_count
    tracer = telemetry.enable(run_id="chip-smoke-phase-12a")

    checkpoint_metrics.reset()
    full, fdrv, sec, snap = run("full", data(), fire_once_detector(
        RF_FIRE_CALL))
    ck = checkpoint_metrics.snapshot()
    finite = bool(torch.isfinite(full.params_flat()).all())
    say(f"LeNet bf16 ResilientFit, data/mnist B={LENET_B}, {RF_EPOCHS} "
        f"epochs ({steps} steps), async snapshots every {RF_EVERY}: "
        f"{sec:.3f} s (host clock, synchronized) for {fdrv.steps_run} steps "
        f"run ({fdrv.steps_run / sec:.1f} steps/s, each with its loss read "
        f"on the host); steps_skipped {snap.get('steps_skipped', 0)} (bar "
        f"1), rollbacks {fdrv.rollbacks} (bar 1), final params finite "
        f"{finite}; {ck['snapshots_committed']} snapshots committed, "
        f"{ck['bytes_written']} bytes, staging {ck['stage_ms']:.3f} ms "
        f"summed over {ck['saves_async']} async saves, writer "
        f"{ck['write_ms']:.3f} ms summed, latest write-behind lag "
        f"{ck['write_behind_lag_ms']:.3f} ms, backpressure waits "
        f"{ck['backpressure_waits']}")
    check(snap.get("steps_skipped", 0) == 1 and full.guard_skips == 1,
          f"LeNet ResilientFit: steps_skipped {snap}")
    check(fdrv.rollbacks == 1 and snap.get("rollbacks") == 1,
          f"LeNet ResilientFit: rollbacks {fdrv.rollbacks}")
    check(finite, "LeNet ResilientFit: non-finite params")

    # kill and resume: the slice and its resume share the poisoned batch
    # and the detector, as one process's run would
    batches, det = data(), fire_once_detector(RF_FIRE_CALL)
    _, sdrv, s1, _ = run("split", batches, det, max_steps=RF_SLICE)
    check(sdrv.steps_run == RF_SLICE and sdrv.manager.latest_step()
          == RF_SLICE, f"slice stopped at {sdrv.manager.latest_step()}")
    part, rdrv, s2, rsnap = run("split", batches, det, resume=True)
    same_params = all(torch.equal(a, b) for (_, a), (_, b) in zip(
        rf_leaves(full.params), rf_leaves(part.params)))
    # the newest snapshot both runs committed: params and optimizer state
    last = max(set(fdrv.manager.all_steps())
               & set(rdrv.manager.all_steps()))
    _, ups = full._backprop_machinery()
    tpl = ([{k: v.clone() for k, v in p.items()} for p in full.params],
           [u.init(p) for u, p in zip(ups, full.params)])
    fa_, _ = fdrv.manager.restore(step=last, like=tpl)
    ra_, _ = rdrv.manager.restore(step=last, like=tpl)
    pairs = list(zip(rf_leaves(fa_), rf_leaves(ra_)))
    same_snap = all(pa == pb and torch.equal(a, b)
                    for (pa, a), (pb, b) in pairs)
    n_ustate = sum(1 for (p, _), _ in pairs if p.startswith("1/"))
    say(f"kill at step {RF_SLICE} ({s1:.3f} s) and resume ({s2:.3f} s, "
        f"{rdrv.steps_run} steps, rollbacks {rdrv.rollbacks}, "
        f"steps_skipped {rsnap.get('steps_skipped', 0)} in the resume): "
        f"final params torch.equal to the uninterrupted run {same_params}; "
        f"snapshot {last} leaf for leaf ({len(pairs)} leaves, {n_ustate} of "
        f"them momentum and AdaGrad state) {same_snap} (cuDNN "
        f"deterministic)")
    check(same_params and same_snap, "LeNet: resume != uninterrupted run")

    # preemption: a programmatic notice at a step boundary
    guard = PreemptionGuard()

    class Notice(IterationListener):
        def iteration_done(self, model, iteration, score):
            if iteration == RF_PREEMPT_AT:
                guard.request()

    checkpoint_metrics.reset()
    net = lenet_net(ln, "bfloat16", params0, "cuda")
    net.set_listeners([Notice()])
    pdrv = ResilientFit(net, ResilienceConfig(
        checkpoint_dir=os.path.join(tmp, "preempt"),
        checkpoint_every=RF_EVERY), preemption_guard=guard)
    pdrv.fit(data(), num_epochs=RF_EPOCHS, seed=5)
    ck = checkpoint_metrics.snapshot()
    say(f"preemption requested at step {RF_PREEMPT_AT}: preempted "
        f"{pdrv.preempted} after {pdrv.steps_run} steps, latest snapshot "
        f"{pdrv.manager.latest_step()}, final sync snapshots "
        f"{ck['preemption_snapshots']}, sync saves {ck['saves_sync']}")
    check(pdrv.preempted and pdrv.steps_run == RF_PREEMPT_AT + 1
          and pdrv.manager.latest_step() == RF_PREEMPT_AT + 1
          and ck["preemption_snapshots"] == 1 and ck["saves_sync"] == 1,
          "LeNet: preemption did not stop with one final snapshot")
    delta = compile_metrics.compile_count - c0
    say(f"captures after warm-up, across the rollback, the resume and "
        f"the preemption: {delta} (traces {compile_metrics.traces})")
    check(delta == 0, f"LeNet ResilientFit: {delta} captures after warm-up")
    telemetry.disable()
    return tracer


def gpt_snapshot(torch, fa, tmp, say) -> dict:
    """Part (b): an async snapshot of GPT-2 small's training state with
    steps dispatched behind it, restored into a fresh run that replays
    them (see the module docstring).  Returns B1-B3's launches."""
    from deeplearning4j_tpu_torch.models import gpt
    from deeplearning4j_tpu_torch.models.transformer import TrainState
    from deeplearning4j_tpu_torch.runtime.checkpoint import (
        AsyncCheckpointer, CheckpointManager)
    from deeplearning4j_tpu_torch.runtime.metrics import (checkpoint_metrics,
                                                          compile_metrics)
    from deeplearning4j_tpu_torch.runtime.resilience import fold

    cfg = gpt.gpt_config()
    check(cfg.remat and cfg.dropout > 0, "GPT-2 small: remat and dropout")
    B, T = 8, 1024
    rng = np.random.default_rng(12)
    n = GPT_SNAP_AT + GPT_BEHIND + GPT_TIMED
    ids = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, T))
                            .astype(np.int32)).cuda() for _ in range(n)]
    init_fn, step_fn = gpt.make_train_step(cfg)
    gen = torch.Generator(device="cuda")

    def step(state, k):
        # the step's dropout stream is a function of (seed, step), as
        # ResilientFit derives it: a restored run redraws it exactly
        gen.manual_seed(fold(7, 0, k))
        return step_fn(state, ids[k], gen)

    def event_ms(fn):
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        b.synchronize()
        return out, a.elapsed_time(b)

    fa.reset_launches()
    state = init_fn(torch.Generator(device="cuda").manual_seed(0))
    mgr = CheckpointManager(os.path.join(tmp, "gpt"), max_to_keep=2)
    ac = AsyncCheckpointer(mgr, max_in_flight=1)
    # the snapshots' pinned host buffers, before training
    t0 = time.perf_counter()
    pool_bytes = ac.reserve(state)
    reserve_ms = (time.perf_counter() - t0) * 1e3
    for k in range(GPT_SNAP_AT):
        state, _ = step(state, k)
    torch.cuda.synchronize()
    checkpoint_metrics.reset()
    t0 = time.perf_counter()
    handle = ac.save(GPT_SNAP_AT, state, meta={"seed": 7})
    stage_ms = (time.perf_counter() - t0) * 1e3
    behind = []
    for k in range(GPT_SNAP_AT, GPT_SNAP_AT + GPT_BEHIND):
        (state, _), ms = event_ms(lambda k=k: step(state, k))
        behind.append(ms)
    in_flight_at_end = not handle.done()
    ac.wait_until_finished()
    ck = checkpoint_metrics.snapshot()
    nbytes = sum(t.numel() * t.element_size() for _, t in rf_leaves(state)
                 if isinstance(t, torch.Tensor))
    ref = [(p, t.clone() if isinstance(t, torch.Tensor) else t)
           for p, t in rf_leaves(state)]
    # drop the uninterrupted run's aliases: the restored state then lands
    # in the engine's free state set (no new capture)
    state = None
    c0 = compile_metrics.compile_count
    tpl = init_fn(torch.Generator(device="cuda").manual_seed(99))
    restored, meta = mgr.restore(like=tpl)
    tpl = None
    check(restored.step == GPT_SNAP_AT and meta["step"] == GPT_SNAP_AT,
          f"GPT snapshot step {meta['step']}")
    for k in range(GPT_SNAP_AT, GPT_SNAP_AT + GPT_BEHIND):
        restored, _ = step(restored, k)
    torch.cuda.synchronize()
    got = rf_leaves(restored)
    equal = [p for (p, a), (q, b) in zip(got, ref)
             if p != q or not (torch.equal(a, b) if isinstance(a, torch.Tensor)
                               else a == b)]
    captures = compile_metrics.compile_count - c0
    free = []
    for k in range(GPT_SNAP_AT + GPT_BEHIND, n):
        (restored, _), ms = event_ms(lambda k=k: step(restored, k))
        free.append(ms)
    launches = fa.launch_counts()
    # a second snapshot: the pool's buffers again, no allocation
    allocs = ac.pool.allocations
    t0 = time.perf_counter()
    ac.save(n, restored, meta={"seed": 7})
    stage2_ms = (time.perf_counter() - t0) * 1e3
    ac.close()
    say(f"GPT-2 small B={B} T={T} (remat, dropout {cfg.dropout}, adamw) "
        f"training state: {nbytes} bytes ({len(ref)} leaves: fp32 params, "
        f"mu and nu, the count, the step) a snapshot; pinned pool "
        f"reserved before training: {pool_bytes} bytes in {reserve_ms:.3f} "
        f"ms; training thread's staging {stage_ms:.3f} ms (clones + copies "
        f"to the pool's pinned buffers queued); writer's commit "
        f"{ck['write_ms']:.3f} ms ({ck['bytes_written']} "
        f"bytes on disk, fsync'd, crc32'd), write-behind lag "
        f"{ck['write_behind_lag_ms']:.3f} ms; snapshot still in flight "
        f"after the {GPT_BEHIND} steps behind it: {in_flight_at_end}; a "
        f"second snapshot's staging {stage2_ms:.3f} ms; pinned buffers "
        f"allocated by the saves {ac.pool.allocations - allocs} after "
        f"the reserve")
    check(stage_ms <= 5 * stage2_ms,
          f"GPT-2 small: first staging {stage_ms:.3f} ms > 5 x the second "
          f"{stage2_ms:.3f} ms")
    say(f"GPT-2 small step ms (CUDA events) with the snapshot in flight "
        + " / ".join(f"{x:.3f}" for x in behind) + ", without "
        + " / ".join(f"{x:.3f}" for x in free))
    say(f"restored at step {GPT_SNAP_AT} into a fresh run, {GPT_BEHIND} "
        f"steps replayed with the same batches and dropout streams: state "
        f"after step {GPT_SNAP_AT + GPT_BEHIND} bit-identical to the "
        f"uninterrupted run's {not equal} ({len(ref)} leaves; differing "
        f"{equal[:4]}); captures across the restore {captures}; B1/B2/B3 "
        f"launches {launches}")
    check(not equal, f"GPT-2 small: restored run differs at {equal[:4]}")
    check(captures == 0, f"GPT-2 small: {captures} captures after restore")
    check(launches["launches"] > 0 and launches["launches_dkv"] > 0
          and launches["launches_dq"] > 0, "B1-B3 did not launch")
    return launches


def telemetry_report(tracer, tmp, say) -> None:
    """Part (c): the registry's snapshot and part (a)'s journal and
    Chrome trace, summarized."""
    from deeplearning4j_tpu_torch.runtime import telemetry

    snap = telemetry.registry.snapshot()
    journal = os.path.join(tmp, "phase12a.jsonl")
    trace = os.path.join(tmp, "phase12a.trace.json")
    tracer.export_journal(journal, snapshot=snap)
    tracer.export_chrome_trace(trace)
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    summary = telemetry.summarize_journal(telemetry.read_journal(journal),
                                          top_k=3)
    tree = {"/".join(r["path"]): (r["count"], r["total_ms"])
            for r in summary["tree"] if r["depth"] <= 1}
    say(f"registry families {sorted(snap['counters'])}; peak_bytes_in_use "
        f"{snap['device_memory']['peak_bytes_in_use']}; checkpoint "
        f"{snap['counters']['checkpoint']}; resilience "
        f"{snap['counters']['resilience']}; compile count "
        f"{snap['counters']['compile']['compile_count']}")
    say(f"journal of part (a): {summary['n_spans']} spans, "
        f"{summary['n_events']} events {summary['events']}; span tree "
        f"(count, total ms) {tree}; Chrome trace {len(events)} events, "
        f"{os.path.getsize(trace)} bytes")
    check(len(snap["counters"]) == 9 and summary["n_spans"] > 0
          and "resilience.rollback" in summary["events"]
          and any(e.get("ph") == "X" for e in events),
          "phase 12: telemetry incomplete")
    peaks = snap["device_memory"]["peak_bytes_in_use"]
    check(all(v is not None and v > 0 for v in peaks.values()),
          f"peak_bytes_in_use not reported: {peaks}")


def resilience_phase(torch, fa, ln, card: str) -> dict:
    """Phase 12 (see the module docstring).  Returns B1-B3's launches."""
    import shutil
    import tempfile

    def say(msg):
        print(f"  {msg} [{card}]")

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        t0 = time.perf_counter()
        tracer = resilient_lenet(torch, ln, tmp, say)
        t1 = time.perf_counter()
        launches = gpt_snapshot(torch, fa, tmp, say)
        t2 = time.perf_counter()
        telemetry_report(tracer, tmp, say)
        say(f"phase 12 wall: (a) {t1 - t0:.1f} s, (b) {t2 - t1:.1f} s, (c) "
            f"{time.perf_counter() - t2:.1f} s")
        return launches
    finally:
        torch.backends.cudnn.deterministic = det
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 13: fit, the solvers, greedy pretraining, Hessian-free and the CLI
# ---------------------------------------------------------------------------

#: the device phase 13 runs on (a CPU rehearsal substitutes "cpu")
FIT_DEVICE = "cuda"
#: card vs CPU on the same activations, fp32 (tests/test_torch_lenet.py)
FIT_SCORE_RTOL = 1e-4
#: Hinton, Osindero & Teh (2006)'s MNIST deep belief net, and the CD-1
#: steps each RBM (or autoencoder) takes a batch
DBN_WIDTHS, DBN_ITERS = (784, 500, 500, 2000), 10
#: CG and L-BFGS iterations on the DBN's output layer, and the score
#: below which card and CPU are no longer compared (fp32's resolution of
#: a cross-entropy near 0)
DBN_SOLVER_ITERS, SOLVER_FLOOR = 30, 1e-3
#: Martens (2010)'s curves deep autoencoder, its training size, and the
#: Hessian-free outer iterations; the score must fall below this share
#: of its start (tests/test_hessian_free.py:130)
CURVES_WIDTHS = (784, 400, 200, 100, 50, 25, 6, 25, 50, 100, 200, 400, 784)
CURVES_N, HF_ITERS, HF_BAR = 20000, 5, 0.9


def mnist_flat(train: bool):
    """data/mnist flattened to [N, 784] and binarized at 30/255 (the
    reference's default, MnistDataFetcher.java)."""
    from deeplearning4j_tpu_torch.datasets.fetchers import MnistDataFetcher

    f = MnistDataFetcher(train=train, flatten=True, binarize=True)
    check(not f.synthetic, "data/mnist not found")
    f.fetch(f.total)
    return f.next()


class PhaseScores:
    """Every listener call of a fit, with the model that made it (the
    network in pretrain and backprop, an optimizer in finetune)."""

    def __init__(self, on_first_solver=None):
        self.rows = []
        self.on_first_solver = on_first_solver

    def iteration_done(self, model, iteration, score):
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

        solver = not isinstance(model, MultiLayerNetwork)
        if solver and self.on_first_solver is not None \
                and not any(s for s, _, _ in self.rows):
            self.on_first_solver()
        self.rows.append((solver, iteration, score))

    def solver_scores(self):
        return [v for s, _, v in self.rows if s]

    def layer_runs(self):
        """The network-made scores split where the iteration restarts at
        0 (pretrain: a run a layer)."""
        runs = []
        for s, it, v in self.rows:
            if s:
                continue
            if it == 0:
                runs.append([])
            runs[-1].append(v)
        return runs


def sync_share(torch, opt, params, n: int) -> float:
    """The share of a gradient-descent solver iteration spent in its host
    read: ``n`` replays of its captured step with the read after each,
    against ``n`` with one read at the end."""
    ustate = opt.updater.init(params)
    it = torch.zeros((), dtype=torch.int32, device=FIT_DEVICE)
    p, u, it, *_ = opt._step(params, ustate, it, None)

    def run(read_each: bool) -> float:
        nonlocal p, u, it
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            p, u, it, score, gnorm, _ = opt._step(p, u, it, None)
            if read_each:
                opt._read(score, gnorm)
        opt._read(score, gnorm)
        return (time.perf_counter() - t0) * 1e3 / n

    # alternate the two, 5 runs each: the host clock on a shared host
    # moves more than the read costs
    runs = {True: [], False: []}
    for _ in range(5):
        for read_each in (True, False):
            runs[read_each].append(run(read_each))
    with_read = float(np.median(runs[True]))
    without = float(np.median(runs[False]))
    return with_read, without, 1.0 - without / with_read


def lenet_fit(torch, ln, tmp, say) -> None:
    """Part (1): LeNet-MNIST through ``fit``; part (2):
    ``prepare_resilient_fit`` -> ``ResilientFit`` on the same conf."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.runtime.metrics import compile_metrics
    from deeplearning4j_tpu_torch.runtime.resilience import (ResilienceConfig,
                                                             ResilientFit)

    train, test = mnist_split(True), mnist_split(False)
    batches = train.batch_by(LENET_B)
    params0 = ln.lenet(device="cpu").params
    merged = DataSet.merge(batches)
    net = lenet_net(ln, "float32", params0, FIT_DEVICE)
    x = torch.as_tensor(merged.features).to(FIT_DEVICE)
    labels = torch.as_tensor(merged.labels).to(FIT_DEVICE)
    with torch.no_grad():
        h = net.hidden_activations(net.params, x)
    rec = PhaseScores()
    net.set_listeners([rec])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net.fit(batches, num_epochs=2)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    ev = net.evaluate(test)
    ft = rec.solver_scores()
    n_ft = net.conf.confs[-1].num_iterations
    say(f"LeNet fp32 fit on data/mnist, B={LENET_B}, 2 epochs: finetune "
        f"(GD) ran {len(ft)} of {n_ft} iterations before a termination, "
        f"score {ft[0]:.6f} -> {ft[-1]:.6f}; then {len(rec.rows) - len(ft)} "
        f"backprop steps; {sec:.3f} s (host clock, synchronized); test "
        f"accuracy {ev.accuracy():.4f} (bar {LENET_MIN_ACC})")
    check(ft[-1] < ft[0], "LeNet fit: finetune's score did not fall")
    check(ev.accuracy() >= LENET_MIN_ACC,
          f"LeNet fit: test accuracy {ev.accuracy()}")

    # the card's finetune against the port's CPU finetune, same params
    # and the same (card) activations
    cpu = lenet_net(ln, "float32", params0, "cpu")
    _, cpu_opt = cpu.finetune_output(h.cpu(), labels.cpu())
    ref = cpu_opt.score_history
    worst = max(abs(a - b) / abs(b) for a, b in zip(ft, ref))
    say(f"finetune scores, card vs CPU on the card's activations: "
        f"{len(ft)} vs {len(ref)} iterations, worst relative difference "
        f"{worst:.3e} (bar {FIT_SCORE_RTOL})")
    check(len(ft) == len(ref) and worst <= FIT_SCORE_RTOL,
          f"LeNet finetune card vs CPU: {worst}")
    fresh = lenet_net(ln, "float32", params0, FIT_DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, opt = fresh.finetune_output(h, labels)
    torch.cuda.synchronize()
    ms_it = (time.perf_counter() - t0) * 1e3 / len(opt.score_history)
    with_read, without, share = sync_share(
        torch, opt, fresh.params[-1], 200)
    say(f"GD finetune iteration ([{h.shape[0]}, {h.shape[1]}] x "
        f"[{h.shape[1]}, 10] objective): {ms_it:.4f} ms in a run (the "
        f"first capture included); {with_read:.4f} ms a replay with the "
        f"host read, {without:.4f} ms without (medians of 5 alternating "
        f"runs of 200): the read's share {100 * share:.1f}%")

    # (2) prepare_resilient_fit -> ResilientFit
    a = lenet_net(ln, "float32", params0, FIT_DEVICE)
    a.finetune(merged)
    b = lenet_net(ln, "float32", params0, FIT_DEVICE)
    batch_list, mesh = b.prepare_resilient_fit(batches)
    same = all(torch.equal(p[k], q[k]) for p, q in zip(a.params, b.params)
               for k in p)
    c0 = compile_metrics.compile_count
    drv = ResilientFit(b, ResilienceConfig(
        checkpoint_dir=os.path.join(tmp, "rf"), checkpoint_every=8))
    drv.fit(batch_list, num_epochs=1, seed=3)
    torch.cuda.synchronize()
    captures = compile_metrics.compile_count - c0
    ev = b.evaluate(test)
    say(f"prepare_resilient_fit: mesh {mesh}, params torch.equal to "
        f"finetune's inside fit {same}; ResilientFit {drv.steps_run} steps, "
        f"{len(drv.manager.all_steps())} snapshots, captures after warm-up "
        f"{captures}, test accuracy {ev.accuracy():.4f}")
    check(mesh is None and same, "prepare_resilient_fit != finetune")
    check(captures == 0, f"ResilientFit after prepare: {captures} captures")


def dbn_conf(kind: str, algo: str = "gradient_descent"):
    """784-500-500-2000 with binary RBMs (CD-1) or denoising autoencoders
    (corruption 0.25, lr 0.01), a 10-way softmax, fp32 products."""
    from deeplearning4j_tpu_torch.nn.conf import (LayerKind,
                                                  NeuralNetConfiguration,
                                                  OptimizationAlgorithm)

    layer = {"rbm": {"kind": LayerKind.RBM, "k": 1},
             # the reconstruction cross-entropy sums over the inputs
             # (up to 784 a row): at lr 0.1 the 500- and 2000-wide layers
             # diverge, so the autoencoders take 0.01
             "autoencoder": {"kind": LayerKind.AUTOENCODER,
                             "corruption_level": 0.25, "lr": 0.01,
                             "activation": "sigmoid"}}[kind]
    b = (NeuralNetConfiguration.builder()
         .n_in(DBN_WIDTHS[0]).lr(0.1).momentum(0.5)
         .num_iterations(DBN_ITERS).use_adagrad(False)
         .activation("sigmoid").compute_dtype("float32")
         .list(len(DBN_WIDTHS)).hidden_layer_sizes(*DBN_WIDTHS[1:]))
    for i in range(len(DBN_WIDTHS) - 1):
        b = b.override(i, **layer)
    return (b.override(len(DBN_WIDTHS) - 1, kind=LayerKind.OUTPUT, n_out=10,
                       activation="softmax", loss_function="mcxent",
                       optimization_algo=OptimizationAlgorithm(algo),
                       num_iterations=(100 if algo == "gradient_descent"
                                       else DBN_SOLVER_ITERS))
            .pretrain(True).backward(True).build())


def falls(run) -> bool:
    """The mean of a run's last 10 scores is below that of its first 10."""
    return float(np.mean(run[-10:])) < float(np.mean(run[:10]))


def pretrain_step_ms(torch, net, i: int, batch) -> float:
    """Device ms of one captured CD-1 (or AE) step of layer ``i`` on a
    batch (CUDA events over replays of the engine's shared step)."""
    from deeplearning4j_tpu_torch.runtime import compile_cache

    step, updater = compile_cache.get_or_build(
        ("multilayer_pretrain_gd", i, net.conf.to_json()),
        lambda: check(False, "pretrain step not built"))
    with torch.no_grad():
        x = net.feed_forward(net.params, batch, upto=i)[-1]
    p, u = net.params[i], updater.init(net.params[i])
    it = torch.zeros((), dtype=torch.int32, device=FIT_DEVICE)
    gen = torch.Generator(device=FIT_DEVICE).manual_seed(0)
    state = [p, u, it]

    def once():
        state[0], state[1], state[2], _, _ = step(*state[:2], x, gen,
                                                  state[2])
    return time_ms(torch, once, iters=50)


def dbn(torch, say):
    """Part (3): the DBN and the AE stack; part (4): CG and L-BFGS on the
    DBN's output layer."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    train, test = mnist_flat(True), mnist_flat(False)
    batches = [DataSet(torch.as_tensor(b.features).to(FIT_DEVICE),
                       torch.as_tensor(b.labels).to(FIT_DEVICE))
               for b in train.batch_by(LENET_B)]
    init = MultiLayerNetwork(dbn_conf("rbm"), device="cpu").init(seed=11)
    params0 = init.params

    def fresh(kind, algo="gradient_descent", params=params0):
        return MultiLayerNetwork(dbn_conf(kind, algo), device=FIT_DEVICE,
                                 params=[{k: v.to(FIT_DEVICE)
                                          for k, v in p.items()}
                                         for p in params])

    net = fresh("rbm")
    snap = {}
    rec = PhaseScores(on_first_solver=lambda: snap.setdefault(
        "params", [{k: v.clone() for k, v in p.items()}
                   for p in net.params]))
    net.set_listeners([rec])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net.fit(batches, num_epochs=1)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    ev = net.evaluate(test)
    runs = rec.layer_runs()
    steps_ms = [pretrain_step_ms(torch, net, i, batches[0].features)
                for i in range(len(DBN_WIDTHS) - 1)]
    say(f"DBN {'-'.join(map(str, DBN_WIDTHS))} (binary RBMs, CD-1, "
        f"{DBN_ITERS} steps a batch, B={LENET_B}) fit: pretrain, finetune "
        f"({len(rec.solver_scores())} GD iterations), 1 backprop epoch in "
        f"{sec:.3f} s (host clock, a score read a pretrain step); "
        f"reconstruction error first/last 10 steps a layer "
        + ", ".join(f"{np.mean(r[:10]):.4f}/{np.mean(r[-10:]):.4f}"
                    for r in runs[:3])
        + f"; CD-1 step device ms a layer "
        + " / ".join(f"{m:.4f}" for m in steps_ms)
        + f"; test accuracy {ev.accuracy():.4f}")
    check(len(runs) >= 3 and all(falls(r) for r in runs[:3]),
          "DBN: an RBM's reconstruction error did not fall")
    again = fresh("rbm")
    again.pretrain(batches)
    same = all(torch.equal(p[k], q[k]) for p, q in
               zip(snap["params"], again.params) for k in p)
    say(f"a second pretrain with the same seed: params torch.equal {same}")
    check(same, "DBN: same-seed pretrains differ")

    ae = fresh("autoencoder")
    arec = PhaseScores()
    ae.set_listeners([arec])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ae.pretrain(batches)
    torch.cuda.synchronize()
    aruns = arec.layer_runs()
    say(f"the same widths with denoising autoencoders (corruption 0.25): "
        f"pretrain {time.perf_counter() - t0:.3f} s, reconstruction loss "
        f"first/last 10 steps a layer "
        + ", ".join(f"{np.mean(r[:10]):.4f}/{np.mean(r[-10:]):.4f}"
                    for r in aruns))
    check(len(aruns) == 3 and all(falls(r) for r in aruns),
          "AE stack: a layer's reconstruction loss did not fall")

    # (4) CG and L-BFGS on the output layer, from where fit's finetune
    # started: the pretrained stack's activations of the merged rows
    merged = DataSet.merge(batches)
    pre = snap["params"]
    with torch.no_grad():
        h = net.hidden_activations(pre, merged.features)
    for algo in ("conjugate_gradient", "lbfgs"):
        card = fresh("rbm", algo, pre)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, opt = card.finetune_output(h, merged.labels)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        cpu = MultiLayerNetwork(dbn_conf("rbm", algo), device="cpu",
                                params=[{k: v.cpu() for k, v in p.items()}
                                        for p in pre])
        _, ref = cpu.finetune_output(h.cpu(), merged.labels.cpu())
        s, r = opt.score_history, ref.score_history
        # held where fp32 resolves the loss: up to the CPU run's first
        # score below SOLVER_FLOOR (L-BFGS drives this separable
        # objective to ~0, where the two devices' roundings decide)
        n = next((i for i, b in enumerate(r) if b < SOLVER_FLOOR), len(r))
        worst = max(abs(a - b) / abs(b) for a, b in zip(s[:n], r[:n]))
        rises = sum(b > a for a, b in zip(s, s[1:]))
        again = fresh("rbm", algo, pre)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again.finetune_output(h, merged.labels)
        torch.cuda.synchronize()
        warm = (time.perf_counter() - t0) * 1e3
        say(f"{algo} on the DBN's output layer ([{h.shape[0]}, "
            f"{h.shape[1]}] x [{h.shape[1]}, 10]), {len(s)} iterations: "
            f"score {s[0]:.6f} -> {s[-1]:.6f}, rises {rises}; trials per "
            f"iteration {opt.trials_history} (CPU "
            f"{'same' if opt.trials_history == ref.trials_history else ref.trials_history}); "
            f"card vs CPU over the {n} iterations before the CPU score "
            f"falls below {SOLVER_FLOOR}: worst relative difference "
            f"{worst:.3e} (bar {FIT_SCORE_RTOL}), trials "
            f"{'equal' if opt.trials_history[:n] == ref.trials_history[:n] else 'differ'}; "
            f"scores a tenth of the way "
            + " ".join(f"{a:.6g}/{b:.6g}" for a, b in
                       list(zip(s, r))[::max(1, len(s) // 10)])
            + f"; {ms / len(s):.3f} ms an iteration with "
            f"the captures, {warm / len(s):.3f} ms in a second run's "
            f"(a host read a trial and an iteration)")
        check(rises == 0, f"{algo}: the score rose")
        check(len(s) == len(r) and n >= 8 and worst <= FIT_SCORE_RTOL
              and opt.trials_history[:n] == ref.trials_history[:n],
              f"{algo}: card vs CPU {worst}, trials {opt.trials_history} "
              f"vs {ref.trials_history}")


def curves_conf():
    """The curves autoencoder with Martens (2010)'s objective for it:
    logistic outputs under cross-entropy (the fused sigmoid/xent pair),
    and each layer's weights drawn from N(0, 9 / fan_in).  Under mse
    (the reference's small test conf) the reference's HF, damping 1 at
    the start and CG stopping at r'r < 1e-10, takes this depth only to
    ~0.91 of its start in 5 iterations (CPU rehearsal, n=1000): mse's
    1/784 scale leaves CG 2-3 iterations an outer one.  Martens' sparse
    init (variance 15 / fan_in) finds no improving CG iterate in its
    first two iterations here."""
    from deeplearning4j_tpu_torch.nn.conf import (LayerKind,
                                                  NeuralNetConfiguration,
                                                  OptimizationAlgorithm,
                                                  WeightInit)

    b = (NeuralNetConfiguration.builder()
         .n_in(CURVES_WIDTHS[0]).compute_dtype("float32")
         .num_iterations(HF_ITERS).activation("sigmoid")
         .optimization_algo(OptimizationAlgorithm.HESSIAN_FREE)
         .list(len(CURVES_WIDTHS) - 1)
         .hidden_layer_sizes(*CURVES_WIDTHS[1:-1]))
    for i, fan_in in enumerate(CURVES_WIDTHS[:-1]):
        b = b.override(i, weight_init=WeightInit.DISTRIBUTION,
                       dist=("normal", 0.0, 3.0 / fan_in ** 0.5))
    return (b.override(len(CURVES_WIDTHS) - 2, kind=LayerKind.OUTPUT,
                       n_out=CURVES_WIDTHS[-1], activation="sigmoid",
                       loss_function="xent")
            .pretrain(False).backward(False).build())


def hessian_free(torch, say) -> None:
    """Part (5): HF on the curves deep autoencoder."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.fetchers import CurvesDataFetcher
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.runtime.metrics import compile_metrics

    f = CurvesDataFetcher(n=CURVES_N, dim=CURVES_WIDTHS[0])
    data = DataSet(torch.from_numpy(f.features).to(FIT_DEVICE),
                   torch.from_numpy(f.labels).to(FIT_DEVICE))
    net = MultiLayerNetwork(curves_conf(), device=FIT_DEVICE).init(seed=13)
    n_params = net.num_params()
    start = net.score(data)
    seen = {}

    class Rec:
        rows = []

        def iteration_done(self, model, iteration, score):
            seen["hf"] = model
            torch.cuda.synchronize()
            self.rows.append((time.perf_counter(), score,
                              compile_metrics.compile_count))

    rec = Rec()
    net.set_listeners([rec])
    torch.cuda.synchronize()
    ms0 = compile_metrics.compile_ms
    t0 = time.perf_counter()
    net.finetune(data)
    capture_ms = compile_metrics.compile_ms - ms0
    hf = seen["hf"]
    times = [t0] + [t for t, _, _ in rec.rows]
    outer = [(b - a) * 1e3 for a, b in zip(times, times[1:])]
    new_captures = rec.rows[-1][2] - rec.rows[0][2]
    params = net.params
    v = [{k: torch.randn_like(t) for k, t in p.items()} for p in params]
    lam = torch.tensor(1.0, device=FIT_DEVICE)
    mv_ms = time_ms(torch, lambda: hf._damped_mv(params, v, lam), iters=10)
    end = rec.rows[-1][1]
    say(f"Hessian-free, curves deep autoencoder "
        f"{'-'.join(map(str, CURVES_WIDTHS))} ({n_params} params, sigmoid, "
        f"xent) on CurvesDataFetcher(n={CURVES_N}): score {start:.6f} -> "
        f"{end:.6f} ({end / start:.3f} of the start, bar {HF_BAR}) in "
        f"{len(rec.rows)} outer iterations; ms an outer iteration "
        + " / ".join(f"{m:.1f}" for m in outer)
        + f"; CG iterations {hf.cg_iterations}; lambda "
        + " / ".join(f"{x:.4f}" for x in hf.lambda_history)
        + f" (the first holds the captures of value, value_and_grad and "
          f"the damped product: {capture_ms:.1f} ms); a damped GN product "
          f"{mv_ms:.3f} ms (CUDA events); new captures after the first "
          f"outer iteration {new_captures}")
    check(end < HF_BAR * start, f"HF: {end} not below {HF_BAR} x {start}")
    check(new_captures == 0, f"HF: {new_captures} captures as lambda adapts")


def cli_runs(torch, ln, tmp, say) -> None:
    """Part (6): the CLI in subprocesses, on the card by default."""
    conf = os.path.join(tmp, "lenet.json")
    with open(conf, "w") as fh:
        fh.write(ln.lenet_conf().to_json())
    model, ck = os.path.join(tmp, "m.bin"), os.path.join(tmp, "ck")
    preds = os.path.join(tmp, "preds.txt")
    env = dict(os.environ, PYTHONPATH=REPO)
    device = [] if FIT_DEVICE == "cuda" else ["--device", FIT_DEVICE]

    def run(*args, ok=True):
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "deeplearning4j_tpu_torch.cli", *args,
             *device], cwd=REPO, env=env, capture_output=True, text=True,
            timeout=600)
        sec = time.perf_counter() - t0
        if ok:
            check(res.returncode == 0,
                  f"cli {args[0]} failed: {res.stdout[-2000:]}"
                  f"{res.stderr[-2000:]}")
        return res, sec

    train = ("train", "--input", "mnist2d", "--conf", conf, "--epochs", "1",
             "--batch", str(LENET_B), "--raw-pixels")

    def checkpointed():
        """train --checkpoint-dir, the same again (refused), --resume:
        one after another, into a model file of their own."""
        out = []
        for extra, ok in (((), True), ((), False),
                          (("--resume", "--epochs", "2"), True)):
            out.append(run(*train, "--output", model_ck, "--checkpoint-dir",
                           ck, "--checkpoint-every", "8", *extra, ok=ok))
        return out

    # the checkpointed chain trains into files of its own, so it runs
    # beside the first train; test and predict need only the trained
    # model and run side by side after it (each subprocess's wall time
    # below is under that contention)
    from concurrent.futures import ThreadPoolExecutor
    model_ck = os.path.join(tmp, "m_ck.bin")
    with ThreadPoolExecutor(3) as pool:
        f_ck = pool.submit(checkpointed)
        r, s_train = run(*train, "--output", model)
        acc_train = [ln_ for ln_ in r.stdout.splitlines()
                     if "accuracy" in ln_]
        f_test = pool.submit(run, "test", "--input", "mnist2d-test",
                             "--model", model, "--raw-pixels")
        f_pred = pool.submit(run, "predict", "--input", "mnist2d-test",
                             "--model", model, "--raw-pixels", "--output",
                             preds)
        (r, s_test), (_, s_pred) = f_test.result(), f_pred.result()
        (r_ck, s_ck), (refused, s_ref), (r_res, s_res) = f_ck.result()
    acc_test = [ln_.strip() for ln_ in r.stdout.splitlines()
                if "Accuracy" in ln_]
    test = mnist_split(False)
    got = np.loadtxt(preds, dtype=np.int64)
    acc_pred = float(np.mean(got == np.asarray(test.labels).argmax(1)))
    acc_ck = [ln_ for ln_ in r_ck.stdout.splitlines() if "accuracy" in ln_]
    acc_res = [ln_ for ln_ in r_res.stdout.splitlines() if "accuracy" in ln_]
    say(f"cli train {s_train:.1f} s ({acc_train}), test {s_test:.1f} s "
        f"({acc_test}), predict {s_pred:.1f} s (accuracy of the written "
        f"classes {acc_pred:.4f}), train --checkpoint-dir {s_ck:.1f} s "
        f"({acc_ck}), the same again {s_ref:.1f} s (exit "
        f"{refused.returncode}: {refused.stderr.strip()[-160:]!r}), "
        f"--resume {s_res:.1f} s ({acc_res}); wall time of each "
        f"subprocess, host clock (the checkpointed three beside train, "
        f"then test and predict)")
    check(acc_train and acc_test and acc_ck and acc_res,
          "cli: an accuracy line is missing")
    # one model, one test split: predict's classes score what test says
    check(abs(acc_pred - float(acc_test[0].split()[-1])) < 1e-4,
          f"cli predict's accuracy {acc_pred} != test's {acc_test}")
    err = refused.stderr.strip().splitlines()
    check(refused.returncode == 1 and len(err) == 1
          and "already holds snapshots" in err[0],
          f"cli: a populated --checkpoint-dir was not refused in one line: "
          f"{refused.stderr[-400:]}")


def fit_phase(torch, ln, card: str) -> None:
    """Phase 13 (see the module docstring)."""
    import shutil
    import tempfile

    def say(msg):
        print(f"  {msg} [{card}]")

    tmp = tempfile.mkdtemp(prefix="chip_smoke_fit_")
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    torch.cuda.reset_peak_memory_stats()
    # part (6)'s subprocesses (the CLI) run beside parts 1-5, their lines
    # printed after them (the parts' times are under that load)
    from concurrent.futures import ThreadPoolExecutor
    cli_lines = []
    cli_pool = ThreadPoolExecutor(1)
    try:
        t = [time.perf_counter()]
        cli = cli_pool.submit(cli_runs, torch, ln, tmp, cli_lines.append)
        for part in (lambda: lenet_fit(torch, ln, tmp, say),
                     lambda: dbn(torch, say),
                     lambda: hessian_free(torch, say),
                     cli.result):
            part()
            t.append(time.perf_counter())
        for line in cli_lines:
            say(line)
        wall = [b - a for a, b in zip(t, t[1:])]
        say(f"phase 13 wall: LeNet fit + resilient {wall[0]:.1f} s, DBN + "
            f"AE + CG/L-BFGS {wall[1]:.1f} s, HF {wall[2]:.1f} s, the "
            f"CLI's rest after them {wall[3]:.1f} s (it ran beside them); "
            f"peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MB")
    finally:
        cli_pool.shutdown()
        torch.backends.cudnn.deterministic = det
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 14: GPT-2 small serving at scale
# ---------------------------------------------------------------------------

#: the device phase 14 runs on (a CPU rehearsal substitutes "cpu")
SERVE_DEVICE = "cuda"
#: part 1's small pool: 129 pages of 32 tokens, half the default's
SMALL_POOL = 129
#: part 1's decode-step profile: every slot of bucket 1024 holding a
#: prompt of this many tokens (8 x 15 pages and a page each to grow fit
#: the small pool)
PROFILE_PROMPT = 480
#: part 2: one 512-token system prompt, 32 requests with 32-96-token
#: tails, 32 greedy tokens each
SYS_LEN, SYS_REQS, SYS_TAIL, SYS_TOKENS = 512, 32, (32, 96), 32
#: part 3: 8 prompts of 128 tokens, 128 tokens out, 4 proposals a round
SPEC_PROMPTS, SPEC_LEN, SPEC_TOKENS, SPEC_K = 8, 128, 128, 4
SPEC_BUCKETS = (256,)
#: part 5: 64 requests from 8 client threads, prompts 16-128, 32 tokens
ROUTER_REQS, ROUTER_THREADS, ROUTER_TOKENS = 64, 8, 32
ROUTER_BUCKETS = (64, 128, 256)
#: part 6: the CLI's training steps
CLI_STEPS = 50


def serve_sync(torch) -> None:
    if SERVE_DEVICE == "cuda":
        torch.cuda.synchronize()


def draft_config(gpt):
    """distilgpt2's published shape (Sanh et al. 2019; the Hugging Face
    distilgpt2 config): GPT-2 small's width, heads, vocabulary and
    positions at 6 layers."""
    cfg = gen_config(gpt)
    return dataclasses.replace(cfg, n_layers=cfg.n_layers // 2)


def seeded_params(torch, gpt, cfg, seed: int):
    gen = torch.Generator(device=SERVE_DEVICE)
    gen.manual_seed(seed)
    return gpt.init_params(gen, cfg, device=SERVE_DEVICE)


def step_profile(torch, cfg, eng):
    """(host ms, device ms, kernels) of one decode step with every slot
    of the largest bucket active (prompts of PROFILE_PROMPT)."""
    bucket = eng.buckets[-1]
    rng = np.random.default_rng(9)
    placed = [eng.start(rng.integers(0, cfg.vocab_size, PROFILE_PROMPT),
                        max_tokens=BURST_TOKENS, temperature=BURST_TEMP,
                        seed=i)[:2] for i in range(GEN_SLOTS)]
    check(all(b == bucket for b, _ in placed), "profile slots off-bucket")
    for _ in range(3):
        eng.advance(bucket)
    host = []
    for _ in range(10):
        t0 = time.perf_counter()
        eng.advance(bucket)
        host.append((time.perf_counter() - t0) * 1e3)
    by, _ = profile_kernels(torch, lambda: eng.advance(bucket))
    check(all(eng.last_ran(bucket)), "a profiled slot stalled")
    for b, s in placed:
        eng.release(b, s)
    return (float(np.median(host)), sum(ms for ms, _ in by.values()),
            sum(n for _, n in by.values()))


def paged_against_pinned(torch, gpt, cfg, params, reqs, say) -> None:
    """Part 1: phase 10(b)'s burst through a pinned engine, a paged one
    with the default pool and one with SMALL_POOL pages: every request's
    tokens equal across the three; the small pool's requests wait for
    pages and none fails; every page comes back."""
    from deeplearning4j_tpu_torch.serving.decode import (
        DecodeEngine, default_length_buckets)

    ladder = default_length_buckets(cfg.max_len)
    outs, steps = {}, {}
    for name, kw in (("pinned", {}), ("paged", {"paged": True}),
                     (f"paged, {SMALL_POOL} pages", {"n_pages": SMALL_POOL})):
        eng = DecodeEngine(cfg, params, n_slots=GEN_SLOTS, buckets=ladder,
                           device=SERVE_DEVICE, **kw)
        w = eng.warmup()
        got, wall, snap = serve_burst(torch, eng, reqs)
        kv = (eng.pool_bytes if eng.paged else GEN_SLOTS * sum(
            gpt.slots_bytes_per_slot(cfg, t) for t in ladder))
        host, dev, n_k = step_profile(torch, cfg, eng)
        steps[name] = dev
        pages = ""
        if eng.paged:
            eng.drop_residents()
            check(eng._alloc.in_use() == 0 and eng.pages_unaccounted() == 0,
                  f"{name}: pages held after the drain: "
                  f"{eng._alloc.in_use()}")
            pages = (f"; pool {eng.n_kv_pages} pages of "
                     f"{eng.page_tokens} tokens, peak {snap['pages_in_use_hw']}"
                     f" in use, page utilization "
                     f"{snap['page_utilization']:.3f}, pages_leaked "
                     f"{snap['pages_leaked']}, in_use after the drain and "
                     f"drop_residents 0")
        say(f"(1) {name}: KV {kv} B ({kv / 2 ** 20:.1f} MiB); warmup "
            f"{w['compiles']} captures in {w['warmup_ms']:.0f} ms; burst "
            f"{wall:.3f} s, {BURST * BURST_TOKENS / wall:.1f} tokens/s, "
            f"TTFT p50 {snap['ttft_p50_ms']:.2f} ms, step p50 "
            f"{snap['tok_p50_ms']:.2f} ms{pages}; one decode step at bucket "
            f"{eng.buckets[-1]}, {GEN_SLOTS} slots of {PROFILE_PROMPT}-token "
            f"prompts: "
            f"host {host:.3f} ms (median of 10), device {dev:.3f} ms in "
            f"{n_k} kernels (profiler)")
        outs[name] = got
        del eng
    names = list(outs)
    for n in names[1:]:
        diff = [i for i, (a, b) in enumerate(zip(outs[names[0]], outs[n]))
                if not np.array_equal(a, b)]
        check(not diff, f"{n}: requests {diff} differ from the pinned "
                        f"engine's tokens")
    ratio = steps["paged"] / steps["pinned"] if steps["pinned"] else 0.0
    say(f"(1) all {BURST} requests token-identical across the three "
        f"engines (bf16, greedy and sampled); paged step device / pinned "
        f"{ratio:.3f}")


def system_prompt_requests(cfg):
    """SYS_REQS greedy requests: one SYS_LEN-token system prompt and a
    distinct tail each."""
    rng = np.random.default_rng(14)
    system = rng.integers(0, cfg.vocab_size, SYS_LEN).astype(np.int32)
    return [(np.concatenate([system, rng.integers(
        0, cfg.vocab_size, int(rng.integers(SYS_TAIL[0], SYS_TAIL[1] + 1))
    ).astype(np.int32)]), 0.0, 2000 + i) for i in range(SYS_REQS)]


def mount_ms(torch, eng, store, prompt):
    """(host ms, device ms, bytes) of one stored prefix's upload into the
    card as a hit mounts it (CUDA events around it, and the host clock).
    On the card the store's entries are page-locked, so the upload copies
    straight from them: no staging buffer is made."""
    from deeplearning4j_tpu_torch.serving.decode import _kv_leaves

    hit = store.lookup(prompt, eng.prefill_chunk, eng._prefix_space)
    check(hit is not None, "the system prompt is not in the store")
    like = _kv_leaves(gen_slots_like(torch, eng))
    eng._upload(hit[1], like)               # the allocations, once
    serve_sync(torch)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    eng._upload(hit[1], like)
    end.record()
    host = (time.perf_counter() - t0) * 1e3
    end.synchronize()
    if SERVE_DEVICE == "cuda":
        check(not eng._stage and all(
            torch.from_numpy(p.view(np.uint8)).is_pinned()
            for p in hit[1]),
            "a host-store mount went through a staging copy")
    return host, start.elapsed_time(end), sum(p.nbytes for p in hit[1])


def gen_slots_like(torch, eng):
    """The engine's cache buffers of its largest bucket (their dtypes)."""
    if eng.paged:
        return eng._pool_state()[0]
    with torch.inference_mode():
        return eng._state(eng._buckets[eng.buckets[-1]])[0]


def prefix_part(torch, gpt, cfg, params, say):
    """Part 2: the system-prompt traffic cold (harvesting off) and warm
    (after one request harvested the prefix) on a pinned engine with a
    host PrefixCache and a paged one mounting resident prefixes (and the
    same store).  Returns the paged engine and its store for part 4."""
    from deeplearning4j_tpu_torch.serving.decode import (
        DecodeEngine, PrefixCache, default_length_buckets)

    reqs = system_prompt_requests(cfg)
    ladder = default_length_buckets(cfg.max_len)
    kept = None
    for name, paged in (("pinned + PrefixCache", False),
                        ("paged, resident mounts", True)):
        store = PrefixCache()
        eng = DecodeEngine(cfg, params, n_slots=GEN_SLOTS, buckets=ladder,
                           prefix_cache=store, paged=paged,
                           device=SERVE_DEVICE)
        eng.warmup()
        eng.harvest_enabled = False
        cold, wall_c, snap_c = serve_burst(torch, eng, reqs, SYS_TOKENS)
        eng.harvest_enabled = True
        serve_burst(torch, eng, reqs[:1], SYS_TOKENS)
        eng.flush_harvests()
        warm, wall_w, snap_w = serve_burst(torch, eng, reqs, SYS_TOKENS)
        diff = [i for i, (a, b) in enumerate(zip(cold, warm))
                if not np.array_equal(a, b)]
        check(not diff, f"{name}: warm requests {diff} differ from cold")
        check(snap_w["prefix_hits"] >= SYS_REQS - 1,
              f"{name}: {snap_w['prefix_hits']} hits on the warm pass")
        host, dev, nbytes = mount_ms(torch, eng, store, reqs[0][0])
        say(f"(2) {name}: {SYS_REQS} requests of a {SYS_LEN}-token system "
            f"prompt + {SYS_TAIL[0]}-{SYS_TAIL[1]}-token tails, "
            f"{SYS_TOKENS} greedy tokens: cold {wall_c:.3f} s, TTFT p50 "
            f"{snap_c['ttft_p50_ms']:.2f} p99 {snap_c['ttft_p99_ms']:.2f} "
            f"ms, {snap_c['prefill_dispatches']} prefill chunks; warm "
            f"{wall_w:.3f} s, TTFT p50 {snap_w['ttft_p50_ms']:.2f} p99 "
            f"{snap_w['ttft_p99_ms']:.2f} ms, {snap_w['prefill_dispatches']}"
            f" prefill chunks, {snap_w['prefix_hits']} hits, "
            f"tokens_saved {snap_w['prefill_tokens_saved']}; warm tokens "
            f"equal cold; a {SYS_LEN}-token mount from the host store: "
            f"{nbytes} B in {dev:.3f} ms on the card, {host:.3f} ms on "
            f"the serving thread (CUDA events and host clock; copied "
            f"straight from the page-locked entry)")
        if paged:
            kept = (eng, store, reqs)
        else:
            eng.close()
            del eng
    return kept


def rebind_part(torch, gpt, cfg, eng, store, sys_reqs, reqs, say) -> None:
    """Part 4: rebind the part-2 paged engine to a second seeded tree:
    a busy engine raises; no new capture; the resident registry is empty
    and the store's system prompt of the old weights does not hit; 4
    greedy requests give a fresh engine's tokens on the new tree."""
    from deeplearning4j_tpu_torch.runtime.metrics import (compile_metrics,
                                                          decode_metrics)
    from deeplearning4j_tpu_torch.serving.decode import DecodeEngine

    params2 = seeded_params(torch, gpt, cfg, 1)
    check(eng._alloc.in_use() > 0 and store.stats()["entries"] > 0,
          "part 2 left no resident prefix or store entry to invalidate")
    bucket, slot, _ = eng.start(reqs[0][0], max_tokens=8)
    try:
        eng.rebind_params(params2)
        raise SmokeFailure("rebind_params on a busy engine did not raise")
    except RuntimeError as e:
        check("busy" in str(e), f"rebind on a busy engine: {e}")
    eng.release(bucket, slot)
    c0 = compile_metrics.compile_count
    t0 = time.perf_counter()
    eng.rebind_params(params2)
    rebind_ms = (time.perf_counter() - t0) * 1e3
    check(eng._alloc.in_use() == 0 and not eng._resident,
          f"the resident registry holds {eng._alloc.in_use()} pages after "
          f"the rebind")
    greedy = [r for r in reqs if r[1] == 0.0][:4]
    h0 = decode_metrics.snapshot()["prefix_hits"]
    outs, _, _ = serve_burst(torch, eng, sys_reqs[:1] + greedy)
    hits = decode_metrics.snapshot()["prefix_hits"] - h0
    check(hits == 0, f"{hits} prefix hits on pages of the old weights")
    new_captures = compile_metrics.compile_count - c0
    check(new_captures == 0, f"the rebind cost {new_captures} captures")
    fresh = DecodeEngine(cfg, params2, n_slots=GEN_SLOTS,
                         buckets=eng.buckets, paged=True,
                         device=SERVE_DEVICE)
    fresh.warmup()
    ref, _, _ = serve_burst(torch, fresh, greedy)
    for i, (a, b) in enumerate(zip(outs[1:], ref)):
        check(np.array_equal(a, b), f"rebound request {i} differs from a "
                                    f"fresh engine's")
    say(f"(4) rebind_params to a second seeded tree: {rebind_ms:.1f} ms "
        f"(host clock; the tree cast on the calling thread), a busy engine "
        f"raised, 0 new captures, resident registry emptied, 0 hits on the "
        f"old system prompt, 4 greedy requests equal a fresh engine's")
    eng.close()


def spec_round_ms(torch, eng, prompts, spec: bool):
    """(ms a round or step with every prompt's slot active, tokens
    committed a slot a round), host clock over 10 after 2."""
    placed = [eng.start(p, max_tokens=SPEC_TOKENS)[:2] for p in prompts]
    bucket = placed[0][0]
    n_c, times = [], []
    for i in range(12):
        t0 = time.perf_counter()
        if spec:
            _, c = eng.advance_spec(bucket)
            n_c.append(float(np.mean(c[[s for _, s in placed]])))
        else:
            eng.advance(bucket)
            n_c.append(1.0)
        if i >= 2:
            times.append((time.perf_counter() - t0) * 1e3)
    for b, s in placed:
        eng.release(b, s)
    return float(np.median(times)), float(np.mean(n_c))


def first_near_tie(torch, gpt, logits, temperature: float, seed: int
                   ) -> int:
    """The first of a request's steps (``logits`` ``[n, vocab]``, its
    prompt SPEC_LEN long) whose drawn scores have a top-2 margin below
    PARITY_MARGIN, in logit units, or ``n``.  Greedy draws score the
    logits; sampled ones ``logits + temperature * g``, with ``g`` the
    Gumbel noise of (seed, position) that ``gpt.sample_token`` adds to
    ``logits / temperature``."""
    scores = logits.double()
    if temperature > 0.0:
        pos = torch.arange(SPEC_LEN - 1, SPEC_LEN - 1 + logits.shape[0],
                           device=logits.device)
        keys = gpt._slot_key(torch.full_like(pos, seed), pos)
        scores = scores + temperature * gpt._gumbel(
            keys, logits.shape[-1], logits.device)
    top = torch.topk(scores, 2, dim=-1).values
    low = (top[:, 0] - top[:, 1] < PARITY_MARGIN).nonzero()
    return int(low[0, 0]) if low.numel() else logits.shape[0]


def spec_part(torch, gpt, cfg, params, say) -> None:
    """Part 3: speculative decoding, k = SPEC_K, with the
    distilgpt2-shaped draft and with the target as its own draft."""
    from deeplearning4j_tpu_torch.runtime.metrics import decode_metrics
    from deeplearning4j_tpu_torch.serving.decode import DecodeEngine

    rng = np.random.default_rng(15)
    prompts = [rng.integers(0, cfg.vocab_size, SPEC_LEN).astype(np.int32)
               for _ in range(SPEC_PROMPTS)]
    cfg_d = draft_config(gpt)
    params_d = seeded_params(torch, gpt, cfg_d, 2)
    kw = dict(n_slots=GEN_SLOTS, buckets=SPEC_BUCKETS, device=SERVE_DEVICE)

    def run(eng, temp):
        return serve_burst(torch, eng, [(p, temp, 3000 + i) for i, p in
                                        enumerate(prompts)], SPEC_TOKENS)

    def agree(a, b):
        lead = []
        for x, y in zip(a, b):
            d = np.nonzero(x != y)[0]
            lead.append(int(d[0]) if d.size else SPEC_TOKENS)
        return sum(lead), len(lead) * SPEC_TOKENS

    plain = DecodeEngine(cfg, params, **kw)
    plain.warmup()
    base = {t: run(plain, t) for t in (0.0, BURST_TEMP)}
    plain_ms, _ = spec_round_ms(torch, plain, prompts, False)
    n_tok = SPEC_PROMPTS * SPEC_TOKENS
    say(f"(3) plain bf16: {n_tok / base[0.0][1]:.1f} tokens/s greedy, "
        f"{n_tok / base[BURST_TEMP][1]:.1f} sampled; {plain_ms:.3f} ms a "
        f"step with {SPEC_PROMPTS} slots (host clock)")
    del plain
    for name, draft in (("distilgpt2-shaped draft", (cfg_d, params_d)),
                        ("the target as its own draft", (cfg, params))):
        eng = DecodeEngine(cfg, params, draft=draft, draft_k=SPEC_K, **kw)
        w = eng.warmup()
        line = []
        for t in (0.0, BURST_TEMP):
            outs, wall, snap = run(eng, t)
            same, total = agree(outs, base[t][0])
            line.append(f"temperature {t}: {n_tok / wall:.1f} tokens/s "
                        f"({base[t][1] / wall:.2f}x plain), acceptance "
                        f"{snap['draft_accept_rate']:.3f}, agreement with "
                        f"plain {same}/{total} tokens up to each request's "
                        f"first difference")
        ms, per = spec_round_ms(torch, eng, prompts, True)
        say(f"(3) {name}, k={SPEC_K}, bf16 ({w['compiles']} captures): "
            + "; ".join(line) + f"; {ms:.3f} ms a round, {per:.2f} tokens "
            f"committed a slot a round (host clock, {SPEC_PROMPTS} slots)")
        del eng
    # fp32 (no TF32): spec equals plain, greedy and sampled, pinned and
    # paged, up to each request's first near-tie of the plain chain
    c32 = dataclasses.replace(cfg, compute_dtype="float32")
    d32 = dataclasses.replace(cfg_d, compute_dtype="float32")
    temps = (0.0, BURST_TEMP)
    plain32 = DecodeEngine(c32, params, **kw)
    plain32.warmup()
    ref32 = {t: run(plain32, t)[0] for t in temps}
    del plain32
    cuts = {t: [] for t in temps}
    for i, p in enumerate(prompts):
        for t in temps:
            _, logits = gpt.generate(
                c32, params, torch.from_numpy(p[None]).to(SERVE_DEVICE),
                SPEC_TOKENS, seed=3000 + i, temperature=t,
                max_len=SPEC_BUCKETS[-1], return_logits=True)
            cuts[t].append(first_near_tie(torch, gpt, logits[0], t,
                                          3000 + i))
    for name, draft, paged, ts in (
            ("distilgpt2-shaped", (d32, params_d), False, temps),
            ("distilgpt2-shaped, paged", (d32, params_d), True, temps),
            ("self", (c32, params), False, temps[:1])):
        eng = DecodeEngine(c32, params, draft=draft, draft_k=SPEC_K,
                           paged=paged, **kw)
        eng.warmup()
        for t in ts:
            outs, _, snap = run(eng, t)
            for i, (a, b, n) in enumerate(zip(outs, ref32[t], cuts[t])):
                check(np.array_equal(a[:n], b[:n]),
                      f"fp32 spec ({name}, temperature {t}) request {i} "
                      f"differs from plain within its first {n} tokens")
            acc = snap["draft_accept_rate"]
            if t > 0.0:
                check(acc < 1.0, f"fp32 sampled spec ({name}) accepted "
                                 f"every proposal: no reject round ran")
            say(f"(3) fp32, {name} draft, temperature {t}: token-identical "
                f"to the plain fp32 engine over {sum(cuts[t])}/{n_tok} "
                f"tokens (each request up to its first step of top-2 "
                f"margin < {PARITY_MARGIN} in the drawn scores; "
                f"{sum(c < SPEC_TOKENS for c in cuts[t])} cut); acceptance "
                f"{acc:.3f}")
        if paged:
            eng.drop_residents()
            check(eng._alloc.in_use() == 0 and eng.pages_unaccounted() == 0,
                  f"fp32 spec ({name}): pages held after the drain")
        del eng
    # paged + spec + int8 weights + int8 KV through the batcher
    eng = DecodeEngine(cfg, params, paged=True, quantize="int8",
                       kv_dtype="int8", draft=(cfg_d, params_d),
                       draft_k=SPEC_K, **kw)
    eng.warmup()
    outs, wall, snap = run(eng, 0.0)
    check(eng.n_active() == 0, "paged spec int8: slots left active")
    eng.drop_residents()
    check(eng._alloc.in_use() == 0 and eng.pages_unaccounted() == 0,
          "paged spec int8: pages held after the drain")
    same, total = agree(outs, base[0.0][0])
    say(f"(3) paged + spec (distilgpt2-shaped) + int8 weights + int8 KV "
        f"through the batcher: {n_tok / wall:.1f} tokens/s, acceptance "
        f"{snap['draft_accept_rate']:.3f}, every slot and page freed, "
        f"agreement with bf16 plain {same}/{total} tokens up to each "
        f"request's first difference")
    del eng


def router_part(torch, gpt, cfg, params, say) -> None:
    """Part 5: Router.replicate with 2 replicas on the card, client
    threads, the typed shed, and an evacuated replica's requests
    replayed on the other."""
    from deeplearning4j_tpu_torch.runtime.metrics import decode_metrics
    from deeplearning4j_tpu_torch.serving.decode import _ReplayRequest
    from deeplearning4j_tpu_torch.serving.router import (OverloadedError,
                                                         Router)

    rng = np.random.default_rng(16)
    reqs = [(rng.integers(0, cfg.vocab_size, int(rng.integers(16, 129))
                          ).astype(np.int32),
             0.0 if i % 2 == 0 else BURST_TEMP, 4000 + i)
            for i in range(ROUTER_REQS)]
    serve_sync(torch)
    m0 = torch.cuda.memory_allocated() if SERVE_DEVICE == "cuda" else 0
    t0 = time.perf_counter()
    router = Router.replicate(cfg, params, 2, device=SERVE_DEVICE,
                              n_slots=GEN_SLOTS, buckets=ROUTER_BUCKETS,
                              default_max_tokens=ROUTER_TOKENS)
    build = time.perf_counter() - t0
    m1 = torch.cuda.memory_allocated() if SERVE_DEVICE == "cuda" else 0
    outs = [None] * ROUTER_REQS
    errors = []

    def client(k):
        try:
            for i in range(k, ROUTER_REQS, ROUTER_THREADS):
                p, t, s = reqs[i]
                outs[i] = router.submit(p, max_tokens=ROUTER_TOKENS,
                                        temperature=t, seed=s).result(600)
        except Exception as e:          # noqa: BLE001 -- held below
            errors.append(e)

    decode_metrics.reset()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(k,))
               for k in range(ROUTER_THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    check(not errors, f"router clients failed: {errors[:2]}")
    check(all(o is not None and o.shape == (ROUTER_TOKENS,) for o in outs),
          "a routed request did not complete")
    a, b = router.routed
    check(abs(a - b) <= ROUTER_REQS // 8,
          f"replicas served {router.routed}: more than a quarter apart")
    say(f"(5) Router.replicate(n_replicas=2) on one card: {build:.1f} s to "
        f"build and warm both, {(m1 - m0) / 2 / 2 ** 20:.1f} MiB a replica "
        f"(memory_allocated, params shared); {ROUTER_REQS} requests from "
        f"{ROUTER_THREADS} client threads in {wall:.3f} s "
        f"({ROUTER_REQS * ROUTER_TOKENS / wall:.1f} tokens/s), served "
        f"{router.routed}")
    # the shed
    shed = Router(router.batchers, max_queue_depth=2)
    s0 = decode_metrics.snapshot()["requests_shed"]
    accepted, rejected = [], 0
    for p, t, s in reqs:
        try:
            accepted.append(shed.submit(p, max_tokens=ROUTER_TOKENS,
                                        temperature=t, seed=s))
        except OverloadedError as e:
            check(e.bound == 2 and e.replicas == 2, f"shed: {e}")
            rejected += 1
    done = [h.result(600) for h in accepted]
    n_shed = decode_metrics.snapshot()["requests_shed"] - s0
    check(rejected > 0 and n_shed == rejected,
          f"shed {rejected} rejections, requests_shed {n_shed}")
    check(all(d.shape == (ROUTER_TOKENS,) for d in done),
          "an accepted request did not complete")
    say(f"(5) max_queue_depth=2 under a {ROUTER_REQS}-request burst: "
        f"{len(accepted)} accepted and completed, {rejected} typed "
        f"OverloadedError, requests_shed {n_shed}")
    # evacuate replica 0 mid-burst; its requests finish on replica 1
    moving = reqs[:16]
    expect = [router.batchers[1].submit(p, max_tokens=ROUTER_TOKENS,
                                        temperature=t, seed=s)
              for p, t, s in moving]
    expect = [h.result(600) for h in expect]
    r0 = decode_metrics.snapshot()["requests_replayed"]
    handles = [router.batchers[0].submit(p, max_tokens=ROUTER_TOKENS,
                                         temperature=t, seed=s)
               for p, t, s in moving]
    deadline = time.time() + 120
    while len(handles[0]._tokens) < 4 and time.time() < deadline:
        time.sleep(0.001)
    moved = router.batchers[0].evacuate()
    for r in moved:
        router.batchers[1].resubmit(_ReplayRequest(r))
        decode_metrics.note_request_replayed()
    got = [h.result(600) for h in handles]
    diff = [i for i, (x, y) in enumerate(zip(got, expect))
            if not np.array_equal(x, y)]
    check(moved and not diff,
          f"evacuated {len(moved)}; replayed requests {diff} differ from "
          f"the undisturbed run")
    say(f"(5) evacuate() of replica 0 mid-burst: {len(moved)} of "
        f"{len(moving)} requests resubmitted to replica 1 (greedy and "
        f"sampled), all {len(moving)} token-identical to the undisturbed "
        f"run; requests_replayed "
        f"{decode_metrics.snapshot()['requests_replayed'] - r0}")
    router.close()


def cli_generate(torch, tmp, say) -> dict:
    """Part 6: cli generate in subprocesses on the card: train a
    char-GPT CLI_STEPS steps and save it, then serve the saved npz
    greedily twice.  Returns the training run's hand-kernel launches."""
    env = dict(os.environ, PYTHONPATH=REPO)
    npz = os.path.join(tmp, "g.npz")
    device = [] if SERVE_DEVICE == "cuda" else ["--device", SERVE_DEVICE]
    prompts = ["--prompt", "the quick ", "--prompt", "a lazy dog "]
    # cli.main in a subprocess, then the process's kernel launch counts
    counted = ("import json, sys\n"
               "from deeplearning4j_tpu_torch import cli\n"
               "from deeplearning4j_tpu_torch.ops import flash_attention "
               "as fa\n"
               "rc = cli.main(sys.argv[1:])\n"
               "print('hand-kernel launches ' + json.dumps("
               "fa.launch_counts()))\n"
               "sys.exit(rc)\n")

    def run(args):
        t0 = time.perf_counter()
        res = subprocess.run(args, cwd=REPO, env=env, capture_output=True,
                             text=True, timeout=600)
        check(res.returncode == 0, f"cli generate failed: "
                                   f"{res.stdout[-2000:]}{res.stderr[-2000:]}")
        return res.stdout, time.perf_counter() - t0

    out, s_train = run([sys.executable, "-c", counted, "generate",
                        "--train-steps", str(CLI_STEPS), "--save-params",
                        npz, "--replicas", "1", *prompts, *device])
    launches = json.loads(out.split("hand-kernel launches ", 1)[1]
                          .splitlines()[0])
    # the two serving runs read the saved npz side by side
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(2) as pool:
        runs = [pool.submit(run, [sys.executable, "-m",
                                  "deeplearning4j_tpu_torch.cli", "generate",
                                  "--params", npz, "--temperature", "0",
                                  *prompts, *device]) for _ in range(2)]
        runs = [f.result() for f in runs]
    texts = [[ln for ln in o.splitlines() if " -> " in ln] for o, _ in runs]
    secs = [s for _, s in runs]
    check(len(texts[0]) == 2 and texts[0] == texts[1],
          f"cli generate --params --temperature 0 differs between runs: "
          f"{texts}")
    loss = [ln for ln in out.splitlines() if "final LM loss" in ln]
    say(f"(6) cli generate --train-steps {CLI_STEPS} --save-params: "
        f"{s_train:.1f} s ({loss}), hand-kernel launches {launches} (the "
        f"char-GPT's training through make_train_step's defaults); "
        f"--params --temperature 0 twice, side by side: {secs[0]:.1f} s / "
        f"{secs[1]:.1f} s, identical: {texts[0]}")
    return launches


def serving_scale_phase(torch, fa, fw, fg, card: str) -> dict:
    """Phase 14 (see the module docstring).  Returns the hand-kernel
    launches of its CLI run."""
    import shutil
    import tempfile

    from deeplearning4j_tpu_torch.models import gpt

    def say(msg):
        print(f"  {msg} [{card}]")

    cfg = gen_config(gpt)
    params = seeded_params(torch, gpt, cfg, 0)
    if SERVE_DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    from deeplearning4j_tpu_torch.serving.decode import (
        default_length_buckets)

    kv_tok = gpt.slots_bytes_per_slot(cfg, 1)
    ladder = default_length_buckets(cfg.max_len)
    pool = GEN_SLOTS * (ladder[-1] // gpt.PREFILL_CHUNK) + 1
    say(f"KV a token {kv_tok} B (bf16); the pinned ladder "
        f"{GEN_SLOTS * kv_tok * sum(ladder)} B, the default pool ({pool} "
        f"pages) {pool * gpt.PREFILL_CHUNK * kv_tok} B, the {SMALL_POOL}-"
        f"page pool {SMALL_POOL * gpt.PREFILL_CHUNK * kv_tok} B")
    for mod in (fa, fw, fg):
        mod.reset_launches()
    # part 6's subprocesses (the CLI) run beside parts 1-5: they count
    # their own launches, and they take the card and cores meanwhile
    # (parts 1-5's times below are under that load); their lines print
    # after part 5
    from concurrent.futures import ThreadPoolExecutor
    tmp = tempfile.mkdtemp(prefix="chip-smoke-14-")
    cli_lines = []
    cli_pool = ThreadPoolExecutor(1)
    cli_run = cli_pool.submit(cli_generate, torch, tmp, cli_lines.append)
    wall = []
    t0 = time.perf_counter()
    paged_against_pinned(torch, gpt, cfg, params, burst_requests(cfg), say)
    wall.append(time.perf_counter() - t0)
    kept = prefix_part(torch, gpt, cfg, params, say)
    wall.append(time.perf_counter() - t0 - sum(wall))
    spec_part(torch, gpt, cfg, params, say)
    wall.append(time.perf_counter() - t0 - sum(wall))
    rebind_part(torch, gpt, cfg, *kept, burst_requests(cfg), say)
    del kept
    wall.append(time.perf_counter() - t0 - sum(wall))
    router_part(torch, gpt, cfg, params, say)
    wall.append(time.perf_counter() - t0 - sum(wall))
    hand = {**fa.launch_counts(), "w2v": fw.launches, "glove": fg.launches}
    say(f"hand-kernel launches during parts 1-5: {hand} (no TPU kernel lies "
        f"on the decode paths)")
    check(not any(hand.values()), f"a hand kernel ran in parts 1-5: {hand}")
    try:
        launches = cli_run.result()
    finally:
        cli_pool.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    for line in cli_lines:
        say(line)
    wall.append(time.perf_counter() - t0 - sum(wall))
    peak = (torch.cuda.max_memory_allocated() / 2 ** 20
            if SERVE_DEVICE == "cuda" else 0.0)
    say(f"phase 14 wall: paged vs pinned {wall[0]:.1f} s, prefix store "
        f"{wall[1]:.1f} s, speculative {wall[2]:.1f} s, rebind "
        f"{wall[3]:.1f} s, router {wall[4]:.1f} s, the CLI's rest after "
        f"them {wall[5]:.1f} s ({sum(wall):.1f} s in all; the CLI ran "
        f"beside parts 1-5); peak memory {peak:.1f} MB")
    return launches


# ---------------------------------------------------------------------------
# phase 15: the GPT-2 small serving fleet
# ---------------------------------------------------------------------------

#: part 1's replica (tier2.autoscale at full width, bench.py:2233-2290):
#: 4 slots, one bucket of 32, 16-token prompts, 16 tokens out, one
#: submit every 5 ms; the load lasts at least FLEET_SPAWNS spawn times
#: and FLEET_MIN_REQS requests (5 s: a spawn under load takes up to
#: ~0.5 s, and the submits it holds back arrive at once after it)
FLEET_SLOTS, FLEET_BUCKETS, FLEET_PROMPT, FLEET_TOKENS = 4, (32,), 16, 16
FLEET_GAP_S, FLEET_SPAWNS, FLEET_MIN_REQS, FLEET_DEPTH = 0.005, 5, 1000, 5
#: requests a replica in part 1's saturated throughput
SATURATED = 128
#: a retired replica's memory must come back within this of the
#: one-replica level (memory_allocated after gc.collect())
FLEET_MEM_SLACK = 64 * 2 ** 20
#: part 4: a prompt of more than one 32-token page, so its first chunk
#: is harvested, in one bucket of 64
BROWNOUT_PROMPT, BROWNOUT_BUCKETS = 40, (64,)
#: part 5: client threads submitting while close() runs
RACE_THREADS = 8


def fleet_factory(torch, cfg, params, stats, label, **kw):
    """A zero-argument replica factory: DecodeEngine(n_slots=FLEET_SLOTS,
    buckets=FLEET_BUCKETS, label=...) + warmup() + ContinuousBatcher.
    Each build appends {"factory_ms", "warmup_ms", "compiles", "thread"}
    to ``stats`` (numbers only: no reference to the replica)."""
    from deeplearning4j_tpu_torch.serving.decode import (ContinuousBatcher,
                                                         DecodeEngine)

    kw.setdefault("buckets", FLEET_BUCKETS)

    def factory():
        t0 = time.perf_counter()
        eng = DecodeEngine(cfg, params, n_slots=FLEET_SLOTS, label=label,
                           device=SERVE_DEVICE, **kw)
        w = eng.warmup()
        b = ContinuousBatcher(eng, default_max_tokens=FLEET_TOKENS)
        stats.append({"factory_ms": (time.perf_counter() - t0) * 1e3,
                      "warmup_ms": w["warmup_ms"], "compiles": w["compiles"],
                      "thread": threading.current_thread().name})
        return b
    return factory


def fleet_memory(torch) -> int:
    """Device bytes allocated once garbage is collected (0 on the CPU)."""
    import gc

    gc.collect()
    if SERVE_DEVICE != "cuda":
        return 0
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def wait_drains(router, timeout: float = 120.0) -> None:
    deadline = time.monotonic() + timeout
    while any(t.is_alive() for t in list(router._drains)):
        check(time.monotonic() < deadline, "a retired replica's drain hung")
        time.sleep(0.01)


def check_memory(torch, base: int, what: str, say) -> None:
    now = fleet_memory(torch)
    say(f"{what}: memory_allocated {now / 2 ** 20:.1f} MiB against "
        f"{base / 2 ** 20:.1f} MiB with one replica ({(now - base) / 2 ** 20:+.1f}"
        f" MiB)")
    check(abs(now - base) <= FLEET_MEM_SLACK,
          f"{what}: {(now - base) / 2 ** 20:.1f} MiB not given back")


def fleet_requests(cfg, n: int):
    """n requests of FLEET_PROMPT tokens, half greedy, half sampled at
    BURST_TEMP with their own seeds."""
    rng = np.random.default_rng(15)
    return [(rng.integers(0, cfg.vocab_size, FLEET_PROMPT).astype(np.int32),
             0.0 if i % 2 == 0 else BURST_TEMP, 5000 + i) for i in range(n)]


def offer_load(router, reqs):
    """Submit ``reqs`` one every FLEET_GAP_S from one client thread.
    Returns (handles by index, shed indices, submit ms by index,
    other errors)."""
    from deeplearning4j_tpu_torch.serving.router import OverloadedError

    handles, shed, submit_ms, errors = {}, [], [], []
    t0 = time.perf_counter()
    for i, (p, t, s) in enumerate(reqs):
        wait = t0 + i * FLEET_GAP_S - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        a = time.perf_counter()
        try:
            handles[i] = router.submit(p, max_tokens=FLEET_TOKENS,
                                       temperature=t, seed=s)
        except OverloadedError:
            shed.append(i)
        except Exception as e:          # noqa: BLE001 -- held by the caller
            errors.append(e)
        submit_ms.append((time.perf_counter() - a) * 1e3)
    return handles, shed, submit_ms, errors


def saturated(torch, factory, reqs, say) -> None:
    """Requests/s of 1 and 3 factory replicas on the card, each queue
    filled at once (SATURATED requests a replica), each engine on its
    own stream; then 3 with their engines on the default stream, and 3
    whose signatures go through torch's pytree instead of the compile
    engine's own walk."""
    from deeplearning4j_tpu_torch.runtime import compile_cache

    rates = {}
    walk = compile_cache._walk
    for name, n, own, fast in (
            ("1 replica", 1, True, True), ("3 replicas", 3, True, True),
            ("3 on the default stream", 3, False, True),
            ("3 with pytree signatures", 3, True, False)):
        bs = [factory() for _ in range(n)]
        if not own:
            for b in bs:
                b.engine._stream = None
        if not fast:
            compile_cache._walk = lambda a, struct, leaves: False
        m = SATURATED * n
        t0 = time.perf_counter()
        try:
            hs = [bs[i % n].submit(p, max_tokens=FLEET_TOKENS,
                                   temperature=t, seed=s)
                  for i, (p, t, s) in enumerate(reqs[:m])]
            for h in hs:
                h.result(600)
        finally:
            compile_cache._walk = walk
        rates[name] = m / (time.perf_counter() - t0)
        for b in bs:
            b.close()
        del bs, hs
    say("(1) saturated, each replica's queue filled at once: "
        + ", ".join(f"{k} {v:.1f} requests/s" for k, v in rates.items()))


class HostLoad:
    """What the host gave this process over a window: CPU seconds a wall
    second (``cores``) and the garbage collector's pauses (ms), read
    with ``take()``."""

    def __init__(self):
        import gc

        self._gc, self._start, self.gc_ms = gc, 0.0, 0.0
        gc.callbacks.append(self._note)
        self.take()

    def _note(self, phase, info) -> None:
        if phase == "start":
            self._start = time.perf_counter()
        else:
            self.gc_ms += (time.perf_counter() - self._start) * 1e3

    def take(self):
        """(cores busy, gc ms) since the last take."""
        import resource

        ru = resource.getrusage(resource.RUSAGE_SELF)
        cpu, t = ru.ru_utime + ru.ru_stime, time.perf_counter()
        out = None
        if hasattr(self, "_cpu"):
            out = ((cpu - self._cpu) / (t - self._t), self.gc_ms)
        self._cpu, self._t, self.gc_ms = cpu, t, 0.0
        return out

    def close(self) -> None:
        self._gc.callbacks.remove(self._note)


def autoscale_part(torch, cfg, params, say):
    """Part 1: the same load through a static one-replica Router and an
    AutoscalingRouter, twice each in the order static, autoscaling,
    autoscaling, static (a drift in the host's speed falls on both
    alike); sheds, TTFT, spawns; every accepted request's tokens against
    one undisturbed engine; W captures a spawn; then the second
    autoscaling fleet shrinks to one and a replica is replaced, each
    giving its memory back."""
    from deeplearning4j_tpu_torch.runtime.metrics import (compile_metrics,
                                                          decode_metrics)
    from deeplearning4j_tpu_torch.serving.router import (AutoscalePolicy,
                                                         AutoscalingRouter,
                                                         Router)

    stats = []
    factory = fleet_factory(torch, cfg, params, stats, "fleet")
    ref = factory()                     # the undisturbed engine
    W = stats[0]["compiles"]
    spawn_s = stats[0]["factory_ms"] / 1e3
    n = max(FLEET_MIN_REQS, int(np.ceil(FLEET_SPAWNS * spawn_s / FLEET_GAP_S)))
    per_bin = int(round(0.5 / FLEET_GAP_S))
    reqs = fleet_requests(cfg, n)
    say(f"(1) one factory call: {stats[0]['factory_ms']:.1f} ms, its warm-up "
        f"{stats[0]['warmup_ms']:.1f} ms for W = {W} captures; load: {n} "
        f"requests, one every {FLEET_GAP_S * 1e3:.0f} ms "
        f"({n * FLEET_GAP_S:.2f} s, {n * FLEET_GAP_S / spawn_s:.1f} spawn "
        f"times)")
    check(W == 2 * len(FLEET_BUCKETS), f"W = {W}, not prefill + step")
    saturated(torch, factory, reqs, say)
    names = {}
    for t in threading.enumerate():
        names[t.name.rstrip("0123456789-_ ")] = names.get(
            t.name.rstrip("0123456789-_ "), 0) + 1
    say(f"(1) threads alive before the load: {sum(names.values())} "
        f"({', '.join(f'{k} x{v}' for k, v in sorted(names.items()))}); "
        f"{os.cpu_count()} cores")
    load = HostLoad()
    results = {"static": [], "autoscaling": []}
    for name in ("static", "autoscaling", "autoscaling", "static"):
        trial = f"{name} ({len(results[name]) + 1} of 2)"
        decode_metrics.reset()
        fleet_memory(torch)
        c0, n0 = compile_metrics.compile_count, len(stats)
        if name == "static":
            router = Router([factory()], max_queue_depth=FLEET_DEPTH)
        else:
            router = AutoscalingRouter(factory, AutoscalePolicy(
                1, 3, high_depth=3.0, low_depth=1.0, up_after=2,
                down_after=10 ** 6, cooldown_s=0.2, interval_s=0.02),
                max_queue_depth=FLEET_DEPTH)
            m_one = fleet_memory(torch)
        load.take()
        t0 = time.perf_counter()
        handles, shed, submit_ms, errors = offer_load(router, reqs)
        outs = {i: h.result(600) for i, h in handles.items()}
        wall = time.perf_counter() - t0
        cores, gc_ms = load.take()
        snap = decode_metrics.snapshot()
        check(not errors, f"{trial}: submits failed: {errors[:2]}")
        check(all(o.shape == (FLEET_TOKENS,) for o in outs.values()),
              f"{trial}: an accepted request did not complete")
        results[name].append(len(shed))
        spawned = stats[n0:]
        line = (f"(1) {trial}: {len(shed)} of {n} shed (typed "
                f"OverloadedError), {len(outs)} completed in {wall:.2f} s "
                f"({len(outs) * FLEET_TOKENS / wall:.1f} tokens/s); TTFT p50 "
                f"{snap['ttft_p50_ms']:.2f} ms, p99 {snap['ttft_p99_ms']:.2f} "
                f"ms; submit ms p50 {np.median(submit_ms):.3f}, max "
                f"{max(submit_ms):.1f}; accepted a 0.5 s of offers "
                f"{np.bincount(np.fromiter(outs, int) // per_bin, minlength=-(-n // per_bin)).tolist()}"
                f"; the process busy {cores:.2f} cores, gc pauses "
                f"{gc_ms:.0f} ms (host clock)")
        if name == "autoscaling":
            line += (f"; replicas added {snap['replicas_added']}, "
                     f"shed_by_policy {snap['shed_by_policy']}")
            check(snap["shed_by_policy"] == len(shed),
                  "a shed was not booked by policy")
            delta = compile_metrics.compile_count - c0
            check(all(s["compiles"] == W for s in spawned)
                  and delta == W * len(spawned),
                  f"{delta} captures over {len(spawned)} factory replicas "
                  f"({[s['compiles'] for s in spawned]}): not W = {W} each")
            # a policy spawn that lands at the ceiling the emergency
            # path reached meanwhile is built, then closed
            discarded = len(spawned) - 1 - snap["replicas_added"]
            check(discarded >= 0, "more replicas added than built")
            check(snap["compile_delta_since_mark"] == 0,
                  "a capture after the last spawn's warm-up")
            for s in spawned[1:]:
                kind = ("policy" if s["thread"] == "dl4j-replica-spawn"
                        else "emergency, on the submitting thread")
                say(f"(1) spawn ({kind}): factory {s['factory_ms']:.1f} ms, "
                    f"warm-up (W = {s['compiles']} captures) "
                    f"{s['warmup_ms']:.1f} ms")
            slow = sorted(submit_ms)[-3:]
            line += (f"; {delta} captures = W x {len(spawned)} factory "
                     f"replicas (the first, {snap['replicas_added']} added, "
                     f"{discarded} landed at the ceiling and closed); the "
                     f"slowest submits (the emergency spawn "
                     f"holds the lock): {', '.join(f'{x:.1f}' for x in slow)}"
                     f" ms, {sum(x > 5 for x in submit_ms)} over 5 ms")
        say(line)
        if name == "static":
            router.close()
            del router
            continue
        # every accepted request on the undisturbed engine
        hs = {i: ref.submit(reqs[i][0], max_tokens=FLEET_TOKENS,
                            temperature=reqs[i][1], seed=reqs[i][2])
              for i in outs}
        diff = [i for i, h in hs.items()
                if not np.array_equal(h.result(600), outs[i])]
        check(not diff, f"{trial}: requests {diff[:8]} differ from the "
                        f"undisturbed engine's tokens")
        say(f"(1) {trial}: all {len(outs)} accepted requests (greedy and "
            f"sampled, served while spawns captured) token-identical to one "
            f"undisturbed engine")
        if len(results[name]) == 1:
            router.close()
            del router
            continue
        # grown to the ceiling (by the load, else by hand), then shrunk
        # back to one replica
        grown = router.n_replicas()
        while router.n_replicas() < 3:
            with router._lock:
                router._scale_up("drill")
        say(f"(1) the load grew the fleet to {grown} replicas")
        router.policy.down_after, router.policy.cooldown_s = 1, 0.0
        deadline = time.monotonic() + 60
        while router.n_replicas() > 1:
            check(time.monotonic() < deadline, "the fleet did not shrink")
            router.tick()
            time.sleep(0.03)
        wait_drains(router)
        check_memory(torch, m_one, "(1) grown to 3, shrunk to 1", say)
        c1 = compile_metrics.compile_count
        check(router.replace_replica(router.batchers[0], reason="drill"),
              "replace_replica refused")
        wait_drains(router)
        check(compile_metrics.compile_count - c1 == W,
              "a replacement did not cost exactly W captures")
        check_memory(torch, m_one, "(1) after replace_replica", say)
        router.close()
        del router
    load.close()
    auto, static = results["autoscaling"], results["static"]
    say(f"(1) shed over both trials: the autoscaler {sum(auto)} ({auto}), "
        f"the static router {sum(static)} ({static})")
    check(sum(auto) < sum(static),
          f"the autoscaler shed {sum(auto)} ({auto}), the static router "
          f"{sum(static)} ({static})")
    ref.close()


def swap_drill(torch, cfg, params, params_2, say, quantize=None):
    """Part 2 on one weight format: a two-replica paged fleet swaps to
    params_2 under a greedy client loop; no request fails, one swap is
    booked, 0 captures; 4 greedy requests equal a fresh engine's on
    params_2."""
    from deeplearning4j_tpu_torch.runtime import quantize as qz
    from deeplearning4j_tpu_torch.runtime.metrics import (compile_metrics,
                                                          decode_metrics)
    from deeplearning4j_tpu_torch.serving.router import (AutoscalePolicy,
                                                         AutoscalingRouter)

    what = quantize or "bf16"
    stats = []
    factory = fleet_factory(torch, cfg, params, stats, f"fleet-swap-{what}",
                            paged=True, quantize=quantize)
    router = AutoscalingRouter(factory, AutoscalePolicy(2, 2))
    nbytes = qz.tree_bytes(router.batchers[0].engine.current_params())
    decode_metrics.reset()
    c0 = compile_metrics.compile_count
    reqs = fleet_requests(cfg, 64)
    stop = threading.Event()
    served, errors = [], []

    def client():
        i = 0
        while not stop.is_set():
            p = reqs[i % len(reqs)][0]
            i += 1
            try:
                served.append(router.generate(p, timeout=600,
                                              max_tokens=FLEET_TOKENS))
            except Exception as e:      # noqa: BLE001 -- held below
                errors.append(e)

    t = threading.Thread(target=client)
    t.start()
    try:
        deadline = time.monotonic() + 120
        while len(served) < 4 and time.monotonic() < deadline:
            time.sleep(0.005)
        t0 = time.perf_counter()
        swapped = router.swap_weights(params_2)
        swap_ms = (time.perf_counter() - t0) * 1e3
        n = len(served)
        while len(served) < n + 4 and time.monotonic() < deadline:
            time.sleep(0.005)
    finally:
        stop.set()
        t.join(600)
    check(not t.is_alive(), "the swap's client hung")
    snap = decode_metrics.snapshot()
    check(not errors, f"{what} swap: requests failed: {errors[:2]}")
    check(swapped == 2 and snap["swaps_completed"] == 1,
          f"{what} swap: {swapped} swapped, {snap['swaps_completed']} booked")
    check(compile_metrics.compile_count == c0, f"{what} swap captured")
    prompts = [r[0] for r in reqs[:4]]
    got = [router.generate(p, timeout=600, max_tokens=FLEET_TOKENS)
           for p in prompts]
    router.close()
    del router
    fresh = fleet_factory(torch, cfg, params_2, [], f"fleet-fresh-{what}",
                          paged=True, quantize=quantize)()
    expect = [fresh.generate(p, timeout=600, max_tokens=FLEET_TOKENS)
              for p in prompts]
    fresh.close()
    diff = [i for i, (a, b) in enumerate(zip(got, expect))
            if not np.array_equal(a, b)]
    check(not diff, f"{what} swap: requests {diff} differ from a fresh "
                    f"engine on the new tree")
    say(f"(2) {what}: swap_weights of 2 paged replicas under a greedy "
        f"client: {swap_ms:.1f} ms wall, {len(served)} requests served, 0 "
        f"failed, requests_during_swap {snap['requests_during_swap']}, 0 "
        f"captures; served weights {nbytes} B a replica; 4 greedy "
        f"requests token-identical to a fresh engine on the new tree")
    return stats[0]["compiles"]


def swap_part(torch, cfg, params, params_2, say):
    """Part 2: the swap under traffic (bf16, then int8), and a
    one-replica fleet's swap through a temporary replica."""
    from deeplearning4j_tpu_torch.runtime.metrics import compile_metrics
    from deeplearning4j_tpu_torch.serving.router import (AutoscalePolicy,
                                                         AutoscalingRouter)

    W = swap_drill(torch, cfg, params, params_2, say)
    stats = []
    router = AutoscalingRouter(
        fleet_factory(torch, cfg, params, stats, "fleet-swap-one",
                      paged=True), AutoscalePolicy(1, 2))
    m_one = fleet_memory(torch)
    c0 = compile_metrics.compile_count
    t0 = time.perf_counter()
    n = router.swap_weights(params_2)
    swap_ms = (time.perf_counter() - t0) * 1e3
    check(n == 2 and router.n_replicas() == 1,
          f"one-replica swap: {n} swapped, {router.n_replicas()} left")
    check(compile_metrics.compile_count - c0 == W,
          "the temporary replica did not cost exactly W captures")
    wait_drains(router)
    say(f"(2) one-replica fleet: swap_weights returned 2 in {swap_ms:.1f} "
        f"ms (the temporary replica's factory "
        f"{stats[1]['factory_ms']:.1f} ms), W = {W} captures, 1 replica "
        f"left")
    check_memory(torch, m_one, "(2) the temporary replica retired", say)
    router.close()
    del router
    swap_drill(torch, cfg, params, params_2, say, quantize="int8")


def chaos_part(torch, cfg, params, say) -> None:
    """Part 3: serving/chaos_gate's drill at GPT-2 small's width."""
    from deeplearning4j_tpu_torch.serving import chaos_gate

    t0 = time.perf_counter()
    rc = chaos_gate.main(SERVE_DEVICE, cfg=cfg, params=params,
                         say=lambda m: say(f"(3) {m}"))
    check(rc == 0, "the chaos drill failed")
    say(f"(3) the drill took {time.perf_counter() - t0:.1f} s")


def brownout_part(torch, gpt, cfg, params, say) -> None:
    """Part 4: one paged replica with the distilgpt2-shaped draft and a
    shared PrefixCache at max_replicas=1: with its pages held, submits
    climb the ladder (speculation off, harvesting off), then shed;
    released, idle ticks walk it back.  Every admitted request
    completes; its agreement with a plain engine is printed."""
    from deeplearning4j_tpu_torch.parallel.chaos import ServingChaos
    from deeplearning4j_tpu_torch.runtime.metrics import (compile_metrics,
                                                          decode_metrics)
    from deeplearning4j_tpu_torch.serving.decode import PrefixCache
    from deeplearning4j_tpu_torch.serving.router import (AutoscalePolicy,
                                                         AutoscalingRouter,
                                                         OverloadedError)

    dcfg = draft_config(gpt)
    draft = (dcfg, seeded_params(torch, gpt, dcfg, 2))
    store = PrefixCache()
    stats = []
    factory = fleet_factory(torch, cfg, params, stats, "fleet-brownout",
                            buckets=BROWNOUT_BUCKETS, paged=True,
                            draft=draft, prefix_cache=store)
    router = AutoscalingRouter(factory, AutoscalePolicy(1, 1),
                               max_queue_depth=1)
    b = router.batchers[0]
    eng = b.engine
    rounds, harvests = [], []
    spec, harvest = eng.advance_spec, eng._harvest

    def counted_spec(bucket):
        rounds.append(router.brownout_level())
        return spec(bucket)

    def counted_harvest(*a, **kw):
        harvests.append(router.brownout_level())
        return harvest(*a, **kw)

    eng.advance_spec, eng._harvest = counted_spec, counted_harvest
    rng = np.random.default_rng(18)
    prompt = rng.integers(0, cfg.vocab_size, BROWNOUT_PROMPT).astype(np.int32)
    decode_metrics.reset()
    c0 = compile_metrics.compile_count
    chaos = ServingChaos(b)
    try:
        first = router.generate(prompt, timeout=600, max_tokens=FLEET_TOKENS)
        check(rounds and set(rounds) == {0},
              "no speculative round at level 0")
        chaos.exhaust_pages()
        handles = [router.submit(prompt, max_tokens=FLEET_TOKENS)]
        levels = [router.brownout_level()]
        for _ in range(2):
            handles.append(router.submit(prompt, max_tokens=FLEET_TOKENS))
            levels.append(router.brownout_level())
        check(levels == [0, 1, 2], f"brownout levels {levels}")
        check(not eng.spec_enabled and not eng.harvest_enabled,
              "level 2 left speculation or harvesting on")
        try:
            router.submit(prompt, max_tokens=FLEET_TOKENS)
            check(False, "level 2 did not shed")
        except OverloadedError:
            pass
        n_rounds, n_harvests = len(rounds), len(harvests)
        chaos.release_pages()
        outs = [h.result(600) for h in handles]
        check(len(rounds) == n_rounds, "a speculative round ran at level >= 1")
        check(len(harvests) == n_harvests, "a harvest was queued at level 2")
        deadline = time.monotonic() + 30
        while router.brownout_level():
            check(time.monotonic() < deadline, "the ladder did not walk back")
            router.tick()
            time.sleep(0.03)
        check(eng.spec_enabled and eng.harvest_enabled, "knobs not restored")
        snap = decode_metrics.snapshot()
        check(snap["brownout_transitions"] == 4 and
              snap["shed_by_policy"] == 1,
              f"booked {snap['brownout_transitions']} transitions, "
              f"{snap['shed_by_policy']} sheds")
        again = router.generate(prompt, timeout=600, max_tokens=FLEET_TOKENS)
        check(len(rounds) > n_rounds, "speculation did not come back")
    finally:
        chaos.restore()
        router.close()
    check(compile_metrics.compile_count == c0,
          "a brownout transition captured")
    eng.flush_harvests()
    eng.drop_residents()
    check(eng._alloc.in_use() == 0 and eng.pages_unaccounted() == 0,
          "brownout: pages held after the drain")
    plain = fleet_factory(torch, cfg, params, [], "fleet-plain",
                          buckets=BROWNOUT_BUCKETS, paged=True)()
    expect = plain.generate(prompt, timeout=600, max_tokens=FLEET_TOKENS)
    plain.close()
    agree = [float(np.mean(o == expect)) for o in [first, *outs, again]]
    say(f"(4) brownout: levels 0 -> 1 -> 2 on three submits at depth 1, "
        f"the fourth shed (shed_by_policy 1), {n_rounds} speculative rounds "
        f"before level 1 and none after, harvests {n_harvests} before level "
        f"2 and none after; released, idle ticks walked 2 -> 1 -> 0 (4 "
        f"transitions booked), speculation back; 0 captures; every page "
        f"back.  Agreement with a plain bf16 engine, token by token: "
        f"{', '.join(f'{a:.3f}' for a in agree)} (level 0, the three "
        f"admitted under pressure, level 0 again; held equal only in "
        f"fp32, on the CPU)")


def race_part(torch, cfg, params, say) -> None:
    """Part 5: RACE_THREADS clients submit while close() runs: each
    submit completes or raises RouterClosed; every join is timed."""
    from deeplearning4j_tpu_torch.serving.router import (AutoscalePolicy,
                                                         AutoscalingRouter,
                                                         RouterClosed)

    router = AutoscalingRouter(
        fleet_factory(torch, cfg, params, [], "fleet-race"),
        AutoscalePolicy(1, 1), max_queue_depth=10 ** 6)
    prompt = fleet_requests(cfg, 1)[0][0]
    accepted, outcome = [], {}
    lock = threading.Lock()

    def hammer(k):
        try:
            for _ in range(10 ** 4):
                h = router.submit(prompt, max_tokens=4)
                with lock:
                    accepted.append(h)
                time.sleep(0.01)
            outcome[k] = "exhausted"
        except RouterClosed:
            outcome[k] = "typed"
        except BaseException as e:      # noqa: BLE001 -- held below
            outcome[k] = repr(e)

    threads = [threading.Thread(target=hammer, args=(k,))
               for k in range(RACE_THREADS)]
    for t in threads:
        t.start()
    time.sleep(0.1)
    t0 = time.perf_counter()
    router.close(timeout=120)
    close_s = time.perf_counter() - t0
    for t in threads:
        t.join(120)
    check(not any(t.is_alive() for t in threads), "a racing submit hung")
    check(set(outcome.values()) == {"typed"}, f"racing submits: {outcome}")
    outs = [h.result(120) for h in accepted]
    check(all(np.array_equal(o, outs[0]) for o in outs),
          "an accepted greedy request differs")
    say(f"(5) {RACE_THREADS} client threads racing close(): {len(outs)} "
        f"accepted and completed, every thread then got RouterClosed; "
        f"close() drained in {close_s:.2f} s")


def fleet_phase(torch, fa, fw, fg, card: str) -> None:
    """Phase 15 (see the module docstring)."""
    from deeplearning4j_tpu_torch.models import gpt

    def say(msg):
        print(f"  {msg} [{card}]")

    cfg = gen_config(gpt)
    params = seeded_params(torch, gpt, cfg, 0)
    params_2 = seeded_params(torch, gpt, cfg, 1)
    if SERVE_DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    for mod in (fa, fw, fg):
        mod.reset_launches()
    wall = []
    t0 = time.perf_counter()
    for part in (lambda: autoscale_part(torch, cfg, params, say),
                 lambda: swap_part(torch, cfg, params, params_2, say),
                 lambda: chaos_part(torch, cfg, params, say),
                 lambda: brownout_part(torch, gpt, cfg, params, say),
                 lambda: race_part(torch, cfg, params, say)):
        part()
        wall.append(time.perf_counter() - t0 - sum(wall))
    hand = {**fa.launch_counts(), "w2v": fw.launches, "glove": fg.launches}
    say(f"hand-kernel launches during parts 1-5: {hand} (no TPU kernel lies "
        f"on the decode paths)")
    check(not any(hand.values()), f"a hand kernel ran in phase 15: {hand}")
    peak = (torch.cuda.max_memory_allocated() / 2 ** 20
            if SERVE_DEVICE == "cuda" else 0.0)
    say(f"phase 15 wall: autoscaling {wall[0]:.1f} s, swaps {wall[1]:.1f} s, "
        f"chaos drill {wall[2]:.1f} s, brownout {wall[3]:.1f} s, close race "
        f"{wall[4]:.1f} s ({sum(wall):.1f} s in all); peak memory "
        f"{peak:.1f} MB")


# ---------------------------------------------------------------------------
# phase 16: ResNet-50 training and serving; the MoE LM at GPT-2 small's
# widths
# ---------------------------------------------------------------------------

#: the device phase 16 runs on (a CPU rehearsal substitutes "cpu")
RESNET_MOE_DEVICE = "cuda"
#: bench.py:443-496's shape: ResNet-50, bf16, B=128 at 224x224.  At
#: SGD-Nesterov lr 0.1 with no warm-up the loss on one batch of random
#: labels first rises for about ten steps (the reference's step does the
#: same), then falls: 30 timed steps, the last held below the first
RESNET_B, RESNET_IMAGE, RESNET_STEPS = 128, 224, 30
#: bench.py:481: ResNet-50 forward ~4.1 GMAC an image, training 3x
RESNET_FLOPS_PER_IMAGE = 3 * 2 * 4.1e9
#: fp32 logits, card against CPU: relative L2 (convolution algorithms
#: sum in other orders)
RESNET_PARITY_TOL = 1e-3
RESNET_BUCKETS = (1, 2, 4, 8, 16, 32, 64)
RESNET_SERVE_SIZES = (1, 3, 5, 8, 13, 24, 40, 64)
RESNET_LATENCY_CALLS = 20
#: captured against eager: cuDNN deterministic for both, as phase 11's
#: LeNet; the loss and the parameters' change held at 1e-6 relative
RESNET_GRAPH_STEPS = 3
#: the MoE LM at GPT-2 small's widths, B=8 T=1024, trained with the
#: reference's default adamw(1e-3, weight_decay=0.01) (moe.py:274)
MOE_B, MOE_T, MOE_STEPS = 8, 1024, 10
#: bf16 full depth, kernels against plain attention: the losses (a top-2
#: choice between near-equal gates may flip when attention rounds
#: differently, so the gradients are held in fp32 at depth 2)
MOE_LOSS_TOL = 5e-2
MOE_GRAPH_STEPS = 2


def tree_rel_l2(torch, updaters, got, ref) -> float:
    """Relative L2 difference over two trees' leaves (on the CPU)."""
    return rel_diff(torch, [g.cpu() for g in updaters.tree_leaves(got)],
                    [r.cpu() for r in updaters.tree_leaves(ref)])[1]


def resnet_parity(torch, res, updaters, say) -> None:
    """ResNet-50 fp32 at B=2 224x224: card against CPU, train mode
    (logits and new statistics) and inference mode (on those
    statistics)."""
    cfg = dataclasses.replace(res.resnet50(), compute_dtype="float32")
    params, stats = res.init_params(torch.Generator().manual_seed(0), cfg,
                                    device="cpu")
    x, _ = res.synthetic_batch(1, cfg, 2, RESNET_IMAGE, device="cpu")
    def to_dev(tree):
        return updaters.tree_map(lambda t: t.to(RESNET_MOE_DEVICE), tree)

    with torch.no_grad():
        t0 = time.perf_counter()
        cpu_train, cpu_stats = res.forward(cfg, params, stats, x, train=True)
        cpu_inf, _ = res.forward(cfg, params, cpu_stats, x, train=False)
        cpu_s = time.perf_counter() - t0
        dev_train, dev_stats = res.forward(cfg, to_dev(params), to_dev(stats),
                                           to_dev(x), train=True)
        dev_inf, _ = res.forward(cfg, to_dev(params), to_dev(cpu_stats),
                                 to_dev(x), train=False)
    rows = {"train": tree_rel_l2(torch, updaters, dev_train, cpu_train),
            "inference": tree_rel_l2(torch, updaters, dev_inf, cpu_inf),
            "new stats": tree_rel_l2(torch, updaters, dev_stats, cpu_stats)}
    say(f"ResNet-50 fp32 B=2 {RESNET_IMAGE}x{RESNET_IMAGE}, card against "
        f"CPU (relative L2, tolerance {RESNET_PARITY_TOL:g}): "
        + ", ".join(f"{k} {v:.3e}" for k, v in rows.items())
        + f"; the CPU's two forwards took {cpu_s:.1f} s")
    check(max(rows.values()) <= RESNET_PARITY_TOL,
          f"ResNet-50 fp32 card against CPU: {rows}")


def stem_times(torch, res, say) -> None:
    """The 7x7/s2 stem against the space-to-depth one at B=128 224x224,
    bf16: agreement, and forward and forward+backward device ms."""
    dev = RESNET_MOE_DEVICE
    g = torch.Generator().manual_seed(4)
    x = torch.randn((RESNET_B, RESNET_IMAGE, RESNET_IMAGE, 3),
                    generator=g).to(dev)
    w = (torch.randn((7, 7, 3, 64), generator=g) * 0.05).to(dev)
    w.requires_grad_(True)
    cdt = torch.bfloat16
    stems = {"plain 7x7/s2": lambda: res._conv(x.permute(0, 3, 1, 2), w, 2,
                                               cdt),
             "space-to-depth 4x4/s1": lambda: res._stem_s2d_conv(x, w, cdt)}
    with torch.no_grad():
        a, b = (f() for f in stems.values())
    agree = rel_diff(torch, [b], [a])[1]
    times = {}
    for name, f in stems.items():
        def fwd_bwd(f=f):
            f().float().square().mean().backward()
        with torch.no_grad():
            fwd = time_ms(torch, f, iters=20)
        times[name] = (fwd, time_ms(torch, fwd_bwd, iters=20))
    fastest = min(times, key=lambda k: times[k][1])
    say(f"ResNet-50 stem, bf16 B={RESNET_B}: space-to-depth against plain, "
        f"relative L2 {agree:.3e}; " + "; ".join(
            f"{k} forward {f:.3f} ms, forward+backward {fb:.3f} ms"
            for k, (f, fb) in times.items())
        + f" (CUDA events, 20 calls); faster: {fastest}")
    check(agree <= 1e-2, f"space-to-depth stem differs by {agree}")


def conv_kind(name: str) -> str:
    """A ResNet step kernel's layer, by its name: cuDNN's convolutions
    (its own kernels and the CUTLASS / nvjet products it runs, the FC's
    one product among them), batch norm, elementwise work, the rest."""
    low = name.lower()
    if "norm" in low or "welford" in low:
        return "batch norm"
    if any(m in low for m in ("conv", "xmma", "implicit", "wgrad", "dgrad",
                              "fprop", "cudnn", "gemm", "cublas", "nvjet",
                              "cutlass")):
        return "convolutions and products"
    if "elementwise" in low or "reduce_kernel" in low:
        return "elementwise and reductions"
    return "the rest"


def resnet_train(torch, res, updaters, say):
    """ResNet-50 bf16 B=128 through make_train_step's defaults
    (SGD-Nesterov 0.1/0.9, captured): warm-up, timed steps, loss,
    throughput, MFU, device busy share, eager against captured times.
    Returns the trained state."""
    from deeplearning4j_tpu_torch.runtime.metrics import compile_metrics

    cfg = res.resnet50()
    init_fn, step_fn = res.make_train_step(cfg, device=RESNET_MOE_DEVICE)
    state = init_fn(torch.Generator().manual_seed(0))
    x, y = res.synthetic_batch(0, cfg, RESNET_B, RESNET_IMAGE,
                               device=RESNET_MOE_DEVICE)
    losses, step_s = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(WARMUP_STEPS):
        state, loss = step_fn(state, x, y)
        losses.append(float(loss))
    c0 = compile_metrics.compile_count
    for _ in range(RESNET_STEPS):
        t0 = time.perf_counter()
        state, loss = step_fn(state, x, y)
        losses.append(float(loss))         # synchronizes
        step_s.append(time.perf_counter() - t0)
    caps = compile_metrics.compile_count - c0
    peak = torch.cuda.max_memory_allocated() / 1e9
    ms = float(np.median(step_s)) * 1e3
    flops = RESNET_FLOPS_PER_IMAGE * RESNET_B
    say(f"ResNet-50 bf16 B={RESNET_B} {RESNET_IMAGE}x{RESNET_IMAGE} "
        f"({res.param_count(state.params) / 1e6:.2f} M params): losses "
        + " ".join(f"{v:.4f}" for v in losses)
        + f" ({WARMUP_STEPS} warm-up, {RESNET_STEPS} timed); step {ms:.2f} "
          f"ms (median, host clock, synchronized; min "
          f"{min(step_s) * 1e3:.2f}, max {max(step_s) * 1e3:.2f}), "
          f"{RESNET_B / (ms / 1e3):.1f} images/s, MFU "
          f"{flops / (ms / 1e3) / PEAK_BF16_FLOPS:.2%} at bench.py:481's "
          f"{flops / 1e12:.3f} TFLOP a step; peak memory {peak:.2f} GB; "
          f"captures over the timed steps {caps}")
    check(all(np.isfinite(losses)), f"ResNet-50: non-finite loss {losses}")
    check(losses[-1] < losses[WARMUP_STEPS],
          f"ResNet-50: loss did not fall over the timed steps: {losses}")
    check(caps == 0, f"ResNet-50: {caps} captures after the warm-up")

    holder = [state]

    def captured():
        holder[0], _ = step_fn(holder[0], x, y)

    by = device_ms_by_kernel(torch, captured)
    if by:
        busy = sum(by.values())
        kinds = {}
        for k, v in by.items():
            kinds[conv_kind(k)] = kinds.get(conv_kind(k), 0.0) + v
        say(f"ResNet-50 profile of one captured step: device busy "
            f"{busy:.2f} ms = {busy / ms:.1%} of the median step; "
            + ", ".join(f"{k} {v:.2f} ms ({v / busy:.1%})"
                        for k, v in sorted(kinds.items(),
                                           key=lambda kv: -kv[1])))
        for key, v in sorted(by.items(), key=lambda kv: -kv[1])[:16]:
            print(f"    {v:8.3f} ms  {key[:110]}")
    else:
        say("ResNet-50 profile: no device time reported (not measured)")
    graph = step_fn.graph
    st = updaters.tree_map(torch.clone, (holder[0].params,
                                         holder[0].batch_stats,
                                         holder[0].opt_state))
    graph_times(torch, f"ResNet-50 bf16 B={RESNET_B} step",
                {"eager": lambda: graph.fn(*st, x, y),
                 "captured": captured}, 5, 2, say)
    del st
    return holder[0]


def resnet_graph_equal(torch, res, updaters, say) -> None:
    """Three ResNet-50 B=128 steps through the raw step and through its
    graph from the same state, cuDNN deterministic for both."""
    from deeplearning4j_tpu_torch.runtime.metrics import compile_metrics

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        cfg = res.resnet50()
        init_fn, step_fn = res.make_train_step(cfg, device=RESNET_MOE_DEVICE)
        graph = step_fn.graph
        s0 = init_fn(torch.Generator().manual_seed(3))
        x, y = res.synthetic_batch(2, cfg, RESNET_B, RESNET_IMAGE,
                                   device=RESNET_MOE_DEVICE)
        out = {}
        for how, fn in (("eager", graph.fn), ("captured", graph)):
            st = updaters.tree_map(torch.clone, (s0.params, s0.batch_stats,
                                                 s0.opt_state))
            losses = []
            for k in range(RESNET_GRAPH_STEPS):
                if k == 1:
                    c1 = compile_metrics.compile_count
                *st, loss = fn(*st, x, y)
                losses.append(float(loss))
            out[how] = (np.array(losses), st[0], st[1])
            del st
        caps = compile_metrics.compile_count - c1
        lrel = float(np.max(np.abs(out["captured"][0] - out["eager"][0])
                            / np.abs(out["eager"][0])))
        urel = update_rel(torch, updaters, s0.params, out["captured"][1],
                          out["eager"][1])
        srel = tree_rel_l2(torch, updaters, out["captured"][2],
                           out["eager"][2])
        say(f"ResNet-50 B={RESNET_B}, {RESNET_GRAPH_STEPS} steps captured vs "
            f"eager (cuDNN deterministic): losses " + " / ".join(
                f"{a:.5f}:{b:.5f}" for a, b in zip(out["eager"][0],
                                                   out["captured"][0]))
            + f"; largest relative loss difference {lrel:.3e}, relative L2 "
              f"of p_k - p_0 {urel:.3e}, of the batch stats {srel:.3e} (bar "
              f"{GRAPH_TRAIN_RTOL:g}); captures after the first step {caps}")
        check(max(lrel, urel, srel) <= GRAPH_TRAIN_RTOL,
              f"ResNet-50: captured steps differ from eager "
              f"({lrel}, {urel}, {srel})")
        check(caps == 0, f"ResNet-50: {caps} captures after the first step")
    finally:
        torch.backends.cudnn.deterministic = det


def resnet_serving(torch, res, updaters, state, say) -> None:
    """The trained ResNet-50 (bf16) through InferenceEngine in buckets
    1-64: every bucket captured at warm-up, padded rows against the
    unpadded forward (logits and argmax), and p50/p99 latency a
    bucket."""
    from deeplearning4j_tpu_torch.serving.engine import InferenceEngine

    cfg = res.resnet50()
    served = updaters.tree_map(torch.clone, (state.params,
                                             state.batch_stats))
    apply_fn, _ = res.make_serving_apply(cfg)
    eng = InferenceEngine(apply_fn, params=served, buckets=RESNET_BUCKETS,
                          device=RESNET_MOE_DEVICE)
    warm = eng.warmup(input_shape=(RESNET_IMAGE, RESNET_IMAGE, 3))
    say(f"ResNet-50 serving warm-up: {warm['buckets']} buckets, "
        f"{warm['compiles']} captures, {warm['warmup_ms']:.0f} ms")
    check(warm["compiles"] == len(RESNET_BUCKETS),
          f"ResNet-50 serving warm-up captured {warm['compiles']}")
    images, _ = res.synthetic_batch(5, cfg, max(RESNET_SERVE_SIZES),
                                    RESNET_IMAGE, device=RESNET_MOE_DEVICE)
    err, scale, same, n = 0.0, 0.0, 0, 0
    for rows in RESNET_SERVE_SIZES:
        got = eng.infer(images[:rows])
        with torch.inference_mode():
            ref, _ = res.forward(cfg, *served, images[:rows], train=False)
        e = float((got - ref).abs().max())
        check(torch.allclose(got, ref, rtol=LOGITS_TOL, atol=LOGITS_TOL),
              f"ResNet-50 serving, {rows} rows: logits differ from the "
              f"unpadded forward by up to {e}")
        err, scale = max(err, e), max(scale, float(ref.abs().max()))
        same, n = same + int((got.argmax(-1) == ref.argmax(-1)).sum()), \
            n + rows
    say(f"ResNet-50 serving, requests of {RESNET_SERVE_SIZES} rows against "
        f"the unpadded forward: max|diff| {err:.3e} over logits up to "
        f"{scale:.3e} (rtol and atol {LOGITS_TOL}); argmax agreement "
        f"{same}/{n} = {same / n:.4f} (need >= {MIN_ARGMAX_AGREE})")
    check(same / n >= MIN_ARGMAX_AGREE,
          f"ResNet-50 serving: argmax agreement {same / n}")
    parts = []
    for b in RESNET_BUCKETS:
        lat = []
        for _ in range(RESNET_LATENCY_CALLS):
            t0 = time.perf_counter()
            eng.infer(images[:b], sync=True)
            lat.append((time.perf_counter() - t0) * 1e3)
        parts.append(f"B={b} p50 {np.percentile(lat, 50):.2f} / p99 "
                     f"{np.percentile(lat, 99):.2f} ms")
    say(f"ResNet-50 serving latency, {RESNET_LATENCY_CALLS} synchronized "
        f"requests a bucket (host clock, device-resident images): "
        + "; ".join(parts))


def moe_config(moe):
    """The MoE LM at GPT-2 small's published widths (hidden 768, 12
    layers, 12 heads, vocabulary 50,257, 1,024 positions), each FFN 8
    experts of GPT-2's FFN width 3,072, at the reference's defaults:
    top-2, capacity 1.25, aux weight 1e-2, remat, bf16."""
    return moe.MoETransformerConfig(
        vocab_size=50257, max_len=1024, hidden=768, n_layers=12, n_heads=12,
        d_ff=3072, n_experts=8, top_k=2, capacity_factor=1.25,
        aux_loss_weight=1e-2, remat=True, compute_dtype="bfloat16")


def routing_census(torch, moe, ex, cfg, params, ids, attn):
    """One forward (no grad): (loss, each layer's expert choices ``[N,
    k]``, mean aux, dropped choices)."""
    rec = []

    def ffn(lp, tok):
        C = ex.compute_capacity(tok.shape[0], cfg.n_experts, cfg.top_k,
                                cfg.capacity_factor)
        rec.append(ex.route(ex.router_gates(lp, tok), cfg.top_k, C))
        return ex.moe_ffn(lp, tok, cfg.moe)

    with torch.no_grad():
        loss = float(moe.lm_loss(cfg, params, ids, attn, ffn))
    aux = float(torch.stack([r.aux for r in rec]).mean())
    dropped = int(sum(int((~r.keep).sum()) for r in rec))
    return loss, [r.expert for r in rec], aux, dropped


def moe_components(torch, ex, cfg, params, say) -> None:
    """One layer's routing, dispatch and experts at the main path's
    shapes (N = B T tokens), forward + backward, each profiled alone;
    and the reference's dense one-hot dispatch beside the index form."""
    dev = RESNET_MOE_DEVICE
    N, H, E, k = MOE_B * MOE_T, cfg.hidden, cfg.n_experts, cfg.top_k
    C = ex.compute_capacity(N, E, k, cfg.capacity_factor)
    g = torch.Generator(device=dev).manual_seed(7)
    tok = torch.randn((N, H), generator=g, device=dev).bfloat16()
    tok.requires_grad_(True)
    blk = params["blocks"]
    lp = {"router": blk["router"][0].detach().clone().requires_grad_(True),
          "wi": blk["wi"][0].detach().clone().requires_grad_(True),
          "wo": blk["wo_e"][0].detach().clone().requires_grad_(True)}
    with torch.no_grad():
        gates = ex.router_gates(lp, tok)
        r = ex.route(gates, k, C)
        inbox = ex.dispatch(tok, r, E)
        out = ex._expert_ffn(lp["wi"], lp["wo"], inbox)
    out.requires_grad_(True)
    inbox.requires_grad_(True)
    gates = gates.detach().requires_grad_(True)

    def routing():
        rr = ex.route(ex.router_gates(lp, tok), k, C)
        (rr.weight.float().sum() + rr.aux).backward()

    def dispatch():
        rr = r._replace(weight=r.weight.detach().requires_grad_(True))
        (ex.dispatch(tok, rr, E).float().sum()
         + ex.combine(out, rr).float().sum()).backward()

    def experts():
        ex._expert_ffn(lp["wi"], lp["wo"], inbox).float().sum().backward()

    def dense():
        d, c, _ = ex.route_topk(gates, k, C)
        (torch.einsum("nec,nd->ecd", d, tok).float().sum()
         + torch.einsum("nec,ecd->nd", c, out).float().sum()).backward()

    rows = {}
    for name, run in (("routing", routing), ("dispatch + combine", dispatch),
                      ("experts", experts),
                      ("dense one-hot dispatch + combine", dense)):
        ms, kernels = device_ms(torch, run, 3)
        rows[name] = ms
        if ms is not None:
            print(f"    {name}: {ms:.3f} ms in {kernels:.0f} kernels")
    if None in rows.values():
        say("MoE components: no device time reported (not measured)")
        return
    ratio = rows["dense one-hot dispatch + combine"] / \
        rows["dispatch + combine"]
    say(f"MoE layer components at N={N}, E={E}, C={C}, d={H}, f={cfg.d_ff} "
        f"(forward + backward, profiler, 3 calls each): " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in rows.items())
        + f"; the index form is {ratio:.1f}x faster than the dense form; a "
          f"step runs each {cfg.n_layers} x (2 forwards under remat + 1 "
          f"backward)")


def moe_graph_equal(torch, moe, updaters, step_fn, state, ids, say):
    """MOE_GRAPH_STEPS steps through the raw step (on a copy of the
    state) and through its graph (on the state, already captured):
    losses and the parameters' change at 1e-6 relative, no capture."""
    from deeplearning4j_tpu_torch.runtime.metrics import compile_metrics

    graph = step_fn.graph
    p0 = updaters.tree_map(torch.clone, state.params)
    st = updaters.tree_map(torch.clone, (state.params, state.opt_state))
    eager = []
    for _ in range(MOE_GRAPH_STEPS):
        *st, loss = graph.fn(*st, ids, None)
        eager.append(float(loss))
    c0 = compile_metrics.compile_count
    captured = []
    for _ in range(MOE_GRAPH_STEPS):
        state, loss = step_fn(state, ids)
        captured.append(float(loss))
    caps = compile_metrics.compile_count - c0
    lrel = float(np.max(np.abs(np.array(captured) - np.array(eager))
                        / np.abs(np.array(eager))))
    urel = update_rel(torch, updaters, p0, state.params, st[0])
    say(f"MoE LM, {MOE_GRAPH_STEPS} steps captured vs eager from one state: "
        f"losses " + " / ".join(f"{a:.5f}:{b:.5f}"
                                for a, b in zip(eager, captured))
        + f"; largest relative loss difference {lrel:.3e}, relative L2 of "
          f"p_k - p_0 {urel:.3e} (bar {GRAPH_TRAIN_RTOL:g}); captures {caps}")
    check(max(lrel, urel) <= GRAPH_TRAIN_RTOL,
          f"MoE LM: captured steps differ from eager ({lrel}, {urel})")
    check(caps == 0, f"MoE LM: {caps} captures after the warm-up")
    return state


def moe_fp32_check(torch, fa, moe, ex, updaters, cfg, ids, say) -> None:
    """fp32 at full width, depth 2: one step's gradients through the
    CUDA-core flash kernels against the plain attention, within 1e-4."""
    from deeplearning4j_tpu_torch.models import transformer as tfm

    c32 = dataclasses.replace(cfg, compute_dtype="float32", n_layers=2)
    params = moe.init_params(
        torch.Generator(device=RESNET_MOE_DEVICE).manual_seed(2), c32,
        device=RESNET_MOE_DEVICE)
    before = fa.launch_counts()
    lk, gk = tfm.value_and_grad(lambda p: moe.lm_loss(
        c32, p, ids, fa.make_attn_fn("auto")), params)
    after = fa.launch_counts()
    lp, gp = tfm.value_and_grad(lambda p: moe.lm_loss(
        c32, p, ids, tfm.attention), params)
    rel, leaf, leaf_rel = grad_agreement(updaters, gk, gp)
    del gk, gp
    _, ek, _, _ = routing_census(torch, moe, ex, c32, params, ids,
                                 fa.make_attn_fn("auto"))
    _, ep, _, _ = routing_census(torch, moe, ex, c32, params, ids,
                                 tfm.attention)
    flips = sum(int((a != b).sum()) for a, b in zip(ek, ep))
    launched = {k: after[k] - before[k] for k in after}
    say(f"MoE LM fp32, full width, depth 2: loss {float(lk):.7f} vs "
        f"{float(lp):.7f}; gradients' global relative L2 error {rel:.3e} "
        f"(tolerance {GRAD_TOL_FP32:g}); largest error in {leaf} (relative "
        f"{leaf_rel:.3e}); routing assignments that differ {flips} of "
        f"{c32.n_layers * ids.numel() * c32.top_k}; fp32 kernel launches "
        f"{launched}")
    expect = launches_per_step(c32)
    check(all(launched[k] == expect[k] for k in launched),
          f"MoE fp32 step's launches {launched} are not {expect}")
    check(rel <= GRAD_TOL_FP32, f"MoE fp32 kernel-path gradients differ by "
                                f"{rel}")


def moe_train(torch, fa, moe, ex, updaters, say):
    """The MoE LM at GPT-2 small's widths through make_train_step's
    defaults (flash attention, adamw 1e-3): warm-up, the counted timed
    steps, the aux loss and the dropped tokens, a profile, the
    components, captured against eager, fp32 gradients at depth 2 and
    bf16 losses at full depth against plain attention.  Returns the
    launch counts of the timed steps."""
    from deeplearning4j_tpu_torch.models import transformer as tfm
    from deeplearning4j_tpu_torch.runtime.metrics import compile_metrics

    cfg = moe_config(moe)
    ids = moe.synthetic_ids(0, cfg, MOE_B, MOE_T, device=RESNET_MOE_DEVICE)
    init_fn, step_fn = moe.make_train_step(cfg, device=RESNET_MOE_DEVICE)
    state = init_fn(torch.Generator(device=RESNET_MOE_DEVICE).manual_seed(0))
    n_params = sum(p.numel() for p in updaters.tree_leaves(state.params))
    losses, step_s = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(WARMUP_STEPS):
        state, loss = step_fn(state, ids)
        losses.append(float(loss))
    torch.cuda.synchronize()

    # -- the main path, counted ------------------------------------------
    c0 = compile_metrics.compile_count
    fa.reset_launches()
    for _ in range(MOE_STEPS):
        t0 = time.perf_counter()
        state, loss = step_fn(state, ids)
        losses.append(float(loss))         # synchronizes
        step_s.append(time.perf_counter() - t0)
    counts = fa.launch_counts()
    caps = compile_metrics.compile_count - c0

    peak = torch.cuda.max_memory_allocated() / 1e9
    ms = float(np.median(step_s)) * 1e3
    say(f"MoE LM at GPT-2 small's widths ({n_params / 1e6:.1f} M params, "
        f"{cfg.n_experts} experts of {cfg.d_ff}, top-{cfg.top_k}, capacity "
        f"{cfg.capacity_factor}) B={MOE_B} T={MOE_T}: losses "
        + " ".join(f"{v:.4f}" for v in losses)
        + f" ({WARMUP_STEPS} warm-up, {MOE_STEPS} timed); step {ms:.2f} ms "
          f"(median, host clock, synchronized; min {min(step_s) * 1e3:.2f}, "
          f"max {max(step_s) * 1e3:.2f}), {ids.numel() / (ms / 1e3):.1f} "
          f"tokens/s; peak memory {peak:.2f} GB; captures over the timed "
          f"steps {caps}")
    say(f"MoE LM launches over the {MOE_STEPS} timed steps: {counts} "
        f"({cfg.n_layers} layers, remat)")
    check(all(np.isfinite(losses)), f"MoE LM: non-finite loss {losses}")
    check(losses[-1] < losses[WARMUP_STEPS],
          f"MoE LM: loss did not fall over the timed steps: {losses}")
    check(caps == 0, f"MoE LM: {caps} captures after the warm-up")
    expect = launches_per_step(cfg)
    for name, n in counts.items():
        check(n == expect[name] * MOE_STEPS,
              f"MoE LM: {name} = {n}, not {expect[name]} per step")

    kernel_attn = fa.make_attn_fn("auto")
    lk, ek, aux, dropped = routing_census(torch, moe, ex, cfg, state.params,
                                          ids, kernel_attn)
    choices = cfg.n_layers * ids.numel() * cfg.top_k
    say(f"MoE LM after the timed steps: mean aux loss {aux:.5f} (1.0 is "
        f"balanced), choices dropped at capacity {dropped} of {choices} "
        f"({dropped / choices:.2%})")
    check(np.isfinite(aux), f"MoE LM: aux loss {aux}")

    holder = [state]

    def captured():
        holder[0], _ = step_fn(holder[0], ids)

    by = device_ms_by_kernel(torch, captured)
    if by:
        busy = sum(by.values())

        def named(mark):
            return sum(v for k, v in by.items() if mark in k)

        b1, b2, b3 = (named("flash_fwd"), named("flash_bwd_dkv"),
                      named("flash_bwd_dq"))
        say(f"MoE LM profile of one captured step: device busy {busy:.2f} "
            f"ms = {busy / ms:.1%} of the median step; B1 {b1:.3f} ms, B2 "
            f"{b2:.3f} ms, B3 {b3:.3f} ms ({(b1 + b2 + b3) / busy:.1%}); "
            f"products {gemm_ms(by):.3f} ms ({gemm_ms(by) / busy:.1%})")
        for key, v in sorted(by.items(), key=lambda kv: -kv[1])[:10]:
            print(f"    {v:8.3f} ms  {key[:100]}")
    else:
        say("MoE LM profile: no device time reported (not measured)")
    moe_components(torch, ex, cfg, holder[0].params, say)
    state = moe_graph_equal(torch, moe, updaters, step_fn, holder[0], ids,
                            say)
    del holder

    # -- bf16 full depth: kernels against plain attention ------------------
    lp, ep, _, _ = routing_census(torch, moe, ex, cfg, state.params, ids,
                                  tfm.attention)
    lk, ek, _, _ = routing_census(torch, moe, ex, cfg, state.params, ids,
                                  kernel_attn)
    flips = sum(int((a != b).sum()) for a, b in zip(ek, ep))
    lrel = abs(lk - lp) / abs(lp)
    say(f"MoE LM bf16, full depth, kernels vs plain attention: loss "
        f"{lk:.6f} vs {lp:.6f} (relative {lrel:.3e}, tolerance "
        f"{MOE_LOSS_TOL:g}); routing assignments that differ {flips} of "
        f"{choices}")
    check(lrel <= MOE_LOSS_TOL, f"MoE LM bf16: kernel-path loss differs "
                                f"by {lrel}")
    del state, step_fn, init_fn
    gc_cuda(torch)
    moe_fp32_check(torch, fa, moe, ex, updaters, cfg, ids, say)
    return counts


def gc_cuda(torch) -> None:
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def resnet_moe_phase(torch, fa, fw, fg, card: str) -> dict:
    """Phase 16 (see the module docstring)."""
    from deeplearning4j_tpu_torch.models import moe
    from deeplearning4j_tpu_torch.models import resnet as res
    from deeplearning4j_tpu_torch.ops import updaters
    from deeplearning4j_tpu_torch.parallel import expert as ex
    from deeplearning4j_tpu_torch.runtime import compile_cache

    def say(msg):
        print(f"  {msg} [{card}]")

    # earlier phases' shared engine entries hold their graphs' memory
    compile_cache.clear()
    gc_cuda(torch)
    say(f"phase 16 starts with {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        f"allocated")
    t = [time.perf_counter()]
    for mod in (fa, fw, fg):
        mod.reset_launches()
    resnet_parity(torch, res, updaters, say)
    stem_times(torch, res, say)
    state = resnet_train(torch, res, updaters, say)
    resnet_serving(torch, res, updaters, state, say)
    del state
    gc_cuda(torch)
    resnet_graph_equal(torch, res, updaters, say)
    hand = {**fa.launch_counts(), "w2v": fw.launches, "glove": fg.launches}
    say(f"hand-kernel launches during ResNet-50: {hand} (no TPU kernel "
        f"lies on ResNet's path)")
    check(not any(hand.values()), f"a hand kernel ran on ResNet's path: "
                                  f"{hand}")
    gc_cuda(torch)
    t.append(time.perf_counter())
    counts = moe_train(torch, fa, moe, ex, updaters, say)
    t.append(time.perf_counter())
    gc_cuda(torch)
    say(f"phase 16 wall: ResNet-50 {t[1] - t[0]:.1f} s, MoE LM "
        f"{t[2] - t[1]:.1f} s")
    return counts


# ---------------------------------------------------------------------------
# phase 17: the sharded-fit spine
# ---------------------------------------------------------------------------

#: the device phase 17 runs on (a CPU rehearsal substitutes "cpu")
SPINE_DEVICE = "cuda"
#: GPT-2 small CausalLM, bf16 mixed precision: B=8 T=1024, 4 batches of
#: seeded random ids for 3 epochs, SGD lr 0.05 momentum 0.9 (the
#: reference bench's CausalLM settings, bench.py:2368)
SPINE_B, SPINE_T, SPINE_BATCHES, SPINE_EPOCHS = 8, 1024, 4, 3
SPINE_LR, SPINE_MOMENTUM = 0.05, 0.9
#: the MoE CausalLM: 3 batches for 2 epochs
SPINE_MOE_BATCHES, SPINE_MOE_EPOCHS = 3, 2
#: grad_accum=2 against 1, fp32 at depth 2: params' relative L2 (the
#: microbatch sums add in another order)
SPINE_ACCUM_TOL = 1e-5
#: card against CPU, fp32 at depth 2, T=256: params' relative L2 (the
#: kernels against plain attention, cuBLAS against the CPU's products)
SPINE_CARD_CPU_TOL = 1e-4
SPINE_CARD_CPU_B, SPINE_CARD_CPU_T, SPINE_CARD_CPU_STEPS = 4, 256, 3
#: ResilientFit: 10 steps (5 batches, 2 epochs), a snapshot every 4, the
#: slice stopped after 6 and resumed; GPT-2 small's widths at depth 2 (at
#: 12 layers the part took 26 s of the script's clock, most of it writing
#: and reading its gathered snapshots: the bit-equal resume is the same
#: check at any depth)
SPINE_RF_BATCHES, SPINE_RF_EVERY, SPINE_RF_KILL = 5, 4, 6
SPINE_RF_DEPTH = 2
SPINE_LENET_BATCHES = 4
#: replays timed of the mesh-of-one step
SPINE_MESH_TIMED = 5
SPINE_BN_B = 64
#: a spine step's device kernels by kind, first match wins
SPINE_KINDS = (("B1", ("flash_fwd",)), ("B2", ("flash_bwd_dkv",)),
               ("B3", ("flash_bwd_dq",)), ("NCCL", ("nccl",)),
               ("products", GEMM_MARKS), ("casts and copies", ("copy",)),
               ("softmax", ("softmax", "Softmax")),
               ("layer norm", ("layer_norm", "LayerNorm")),
               ("finite checks", ("ReduceOp<bool", "isfinite")),
               ("elementwise (update, guard, masks)", ("elementwise",)),
               ("reductions", ("reduce",)))


class ScoreLog:
    """A listener keeping every step's score."""

    def __init__(self):
        self.seen = []

    def iteration_done(self, model, i, score):
        self.seen.append(float(score))


def spine_ids(vocab: int, n: int, b: int, t: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (b, t)).astype(np.int32)
            for _ in range(n)]


def spine_batches(ids):
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    return [DataSet(x, x) for x in ids]


def spine_lm(lm_fit, cfg, **kw):
    kw = {"lr": SPINE_LR, "momentum": SPINE_MOMENTUM, **kw}
    return lm_fit.CausalLM(cfg, device=SPINE_DEVICE, **kw)


def spine_sync(torch) -> None:
    if SPINE_DEVICE == "cuda":
        torch.cuda.synchronize()


def spine_kind(name: str) -> str:
    for kind, marks in SPINE_KINDS:
        if any(m in name for m in marks):
            return kind
    return "other"


def spine_profile(torch, what, run, step_ms, say):
    """One call of ``run`` by kernel kind (torch.profiler); returns
    ``(device ms by kind, device ms by kernel)``, empty when no device
    time is reported."""
    by = device_ms_by_kernel(torch, run)
    if not by:
        say(f"{what} profile: no device time reported (not measured)")
        return {}, {}
    kinds = {}
    for k, v in by.items():
        kinds[spine_kind(k)] = kinds.get(spine_kind(k), 0.0) + v
    busy = sum(by.values())
    say(f"{what} profile of one step: device busy {busy:.2f} ms = "
        f"{busy / step_ms:.1%} of the mean step; "
        + ", ".join(f"{k} {v:.3f} ms ({v / busy:.1%})"
                    for k, v in sorted(kinds.items(), key=lambda kv: -kv[1])))
    for key, v in sorted(by.items(), key=lambda kv: -kv[1])[:8]:
        print(f"    {v:8.3f} ms  {key[:100]}")
    return kinds, by


def spine_state(torch, step, params, ids):
    """``(params, ustate, it, batch)`` for direct calls of a CausalLM
    step, the params copied."""
    from deeplearning4j_tpu_torch.ops import updaters

    params = updaters.tree_map(torch.clone, params)
    x = torch.as_tensor(ids).to(SPINE_DEVICE)
    n = torch.full((), x.shape[0], dtype=torch.int32, device=SPINE_DEVICE)
    return (params, step.init_ustate(params),
            torch.zeros((), dtype=torch.int32, device=SPINE_DEVICE),
            (x, x, n))


def spine_gpt(torch, fa, gpt, lm_fit, sf, say):
    """Part 1: GPT-2 small through CausalLM.fit_backprop, bf16."""
    from deeplearning4j_tpu_torch.ops import updaters
    from deeplearning4j_tpu_torch.runtime.metrics import compile_metrics

    cfg = gpt.gpt_config()
    ids = spine_ids(cfg.vocab_size, SPINE_BATCHES, SPINE_B, SPINE_T)
    batches = spine_batches(ids)
    lm = spine_lm(lm_fit, cfg, mixed_precision="bf16").init(0)
    p0 = updaters.tree_map(torch.clone, lm.params)
    n_params = sum(t.numel() for t in updaters.tree_leaves(p0))
    spine_sync(torch)
    if SPINE_DEVICE == "cuda":
        # from before the capture: the graph's pool is allocated there
        torch.cuda.reset_peak_memory_stats()
    # the warm-up: a one-step fit captures the step
    lm.fit_backprop(batches[:1])
    lm.params = updaters.tree_map(torch.clone, p0)
    lm.guard_skips = 0
    log = ScoreLog()
    lm.listeners = [log]

    # -- the main path, counted ------------------------------------------
    c0 = compile_metrics.compile_count
    fa.reset_launches()
    t0 = time.perf_counter()
    lm.fit_backprop(batches, num_epochs=SPINE_EPOCHS)
    spine_sync(torch)
    wall = time.perf_counter() - t0
    counts = fa.launch_counts()
    caps = compile_metrics.compile_count - c0
    lm.listeners = []

    steps = SPINE_EPOCHS * SPINE_BATCHES
    step_ms = wall / steps * 1e3
    tokens = SPINE_B * SPINE_T / (step_ms / 1e3)
    mfu = gpt_train_flops(cfg, SPINE_B, SPINE_T) / (step_ms / 1e3) / 989e12
    peak = (torch.cuda.max_memory_allocated() / 1e9
            if SPINE_DEVICE == "cuda" else float("nan"))
    losses = np.array(log.seen).reshape(SPINE_EPOCHS, SPINE_BATCHES)
    want = sf.init_loss_scale("cpu")
    for _ in range(steps):
        want = sf.next_loss_scale(want, torch.zeros((), dtype=torch.int32))
    scale = float(lm.loss_scale["scale"])
    say(f"GPT-2 small CausalLM ({n_params / 1e6:.1f} M params), bf16 mixed "
        f"precision, B={SPINE_B} T={SPINE_T}, {SPINE_BATCHES} batches x "
        f"{SPINE_EPOCHS} epochs, SGD lr {SPINE_LR} momentum "
        f"{SPINE_MOMENTUM}: losses by epoch "
        + " | ".join(" ".join(f"{v:.4f}" for v in row) for row in losses)
        + f"; step {step_ms:.2f} ms (fit wall / {steps}, host clock, "
          f"synchronized), {tokens:.1f} tokens/s, MFU {mfu:.1%} of 989 "
          f"TFLOP/s; peak memory {peak:.2f} GB (capture included); guard "
          f"skips "
          f"{lm.guard_skips}; loss scale {scale:g} (expected "
          f"{float(want['scale']):g}), good steps "
          f"{int(lm.loss_scale['good_steps'])}; captures in the fit {caps}")
    say(f"GPT-2 small CausalLM launches over the fit: {counts}")
    check(np.isfinite(losses).all(), f"CausalLM: non-finite loss {losses}")
    check(losses[-1].mean() < losses[0].mean(),
          f"CausalLM: the last epoch's mean loss is not below the first's "
          f"{losses}")
    check(lm.guard_skips == 0, f"CausalLM: {lm.guard_skips} guard skips")
    check(scale == float(want["scale"]) and int(lm.loss_scale["good_steps"])
          == int(want["good_steps"]), f"CausalLM: loss scale {lm.loss_scale}")
    check(caps == 0, f"CausalLM: {caps} captures after the first epoch")
    expect = launches_per_step(cfg)
    for name, n in counts.items():
        check(n == expect[name] * steps,
              f"CausalLM: {name} = {n}, not {expect[name]} per step")

    step, _ = lm._backprop_machinery()
    gen = torch.Generator(device=SPINE_DEVICE).manual_seed(0)
    held = list(spine_state(torch, step, lm.params, ids[0]))

    def one():
        held[0], held[1], held[2], _, _ = step(*held, gen)

    one()
    spine_profile(torch, "GPT-2 small CausalLM bf16", one, step_ms, say)
    del held, step
    return counts, cfg, p0, batches, lm.params_flat(), step_ms


def spine_graph_and_guard(torch, gpt, lm_fit, say) -> None:
    """Part 2: at depth 2, two captured steps against the raw step from
    one state, then an inf planted in one param leaf: the guard skips
    the step, params and momentum stay, the scale halves, and the next
    clean step proceeds."""
    from deeplearning4j_tpu_torch.ops import updaters
    from deeplearning4j_tpu_torch.runtime.metrics import compile_metrics

    cfg = dataclasses.replace(gpt.gpt_config(), n_layers=2)
    lm = spine_lm(lm_fit, cfg, mixed_precision="bf16").init(1)
    step, _ = lm._backprop_machinery()
    ids = spine_ids(cfg.vocab_size, 1, SPINE_B, SPINE_T, seed=1)[0]
    eager = list(spine_state(torch, step, lm.params, ids))
    held = list(spine_state(torch, step, lm.params, ids))
    g_e = torch.Generator(device=SPINE_DEVICE).manual_seed(3)
    g_c = torch.Generator(device=SPINE_DEVICE).manual_seed(3)
    le, lc = [], []
    for _ in range(2):
        eager[0], eager[1], eager[2], s, _ = step.fn(*eager, g_e)
        le.append(float(s))
    held[0], held[1], held[2], s, _ = step(*held, g_c)   # captures
    lc.append(float(s))
    c0 = compile_metrics.compile_count
    held[0], held[1], held[2], s, _ = step(*held, g_c)
    lc.append(float(s))
    caps = compile_metrics.compile_count - c0
    rel = tree_rel_l2(torch, updaters, held[0], eager[0])
    lrel = max(abs(a - b) / abs(b) for a, b in zip(lc, le))
    say(f"CausalLM depth 2, bf16: 2 captured steps against the raw step "
        f"from one state: losses {le} vs {lc} (largest relative difference "
        f"{lrel:.3e}), params' relative L2 {rel:.3e} (bar "
        f"{GRAPH_TRAIN_RTOL:g}); captures after the first {caps}")
    check(max(rel, lrel) <= GRAPH_TRAIN_RTOL,
          f"CausalLM: captured steps differ from the raw step ({rel}, {lrel})")
    check(caps == 0, f"CausalLM: {caps} captures after the first step")
    del eager

    w1 = held[0]["blocks"]["w1"]
    saved = float(w1[0, 0, 0])
    w1[0, 0, 0] = float("inf")
    before_p = updaters.tree_map(torch.clone, held[0])
    before_m = updaters.tree_map(torch.clone, held[1][0])
    scale0 = float(held[1][1]["scale"])
    held[0], held[1], held[2], s, skipped = step(*held, g_c)
    same_p = all(torch.equal(a, b) for a, b in zip(
        updaters.tree_leaves(held[0]), updaters.tree_leaves(before_p)))
    same_m = all(torch.equal(a, b) for a, b in zip(
        updaters.tree_leaves(held[1][0]), updaters.tree_leaves(before_m)))
    scale1 = float(held[1][1]["scale"])
    say(f"poisoned step (inf in blocks/w1): skipped {int(skipped)}, loss "
        f"{float(s)}, params unchanged {same_p}, momentum unchanged "
        f"{same_m}, loss scale {scale0:g} -> {scale1:g}")
    check(int(skipped) == 1 and same_p and same_m,
          "CausalLM: the guard did not hold the poisoned step")
    check(scale1 == scale0 / 2, f"CausalLM: the scale went {scale0} -> "
                                f"{scale1}, not halved")
    w1 = held[0]["blocks"]["w1"]
    w1[0, 0, 0] = saved
    before_p = updaters.tree_map(torch.clone, held[0])
    held[0], held[1], held[2], s, skipped = step(*held, g_c)
    moved = tree_rel_l2(torch, updaters, held[0], before_p)
    say(f"the next clean step: skipped {int(skipped)}, loss {float(s):.4f}, "
        f"params moved by relative L2 {moved:.3e}, scale "
        f"{float(held[1][1]['scale']):g}, good steps "
        f"{int(held[1][1]['good_steps'])}")
    check(int(skipped) == 0 and moved > 0 and np.isfinite(float(s)),
          "CausalLM: the clean step after the poisoned one did not proceed")


def spine_accum(torch, gpt, lm_fit, say) -> None:
    """Part 3: fp32 at depth 2, B=8: grad_accum=2 against 1, 3 steps."""
    cfg = dataclasses.replace(gpt.gpt_config(), n_layers=2,
                              compute_dtype="float32", dropout=0.0)
    batches = spine_batches(spine_ids(cfg.vocab_size, 3, SPINE_B, SPINE_T,
                                      seed=2))
    flats = []
    for accum in (1, 2):
        lm = spine_lm(lm_fit, cfg, grad_accum=accum).init(2)
        lm.fit_backprop(batches)
        flats.append(lm.params_flat())
    p1 = spine_lm(lm_fit, cfg).init(2).params_flat()
    rel = float((flats[1] - flats[0]).norm() / flats[0].norm())
    moved = float((flats[0] - p1).norm() / p1.norm())
    say(f"grad_accum=2 against 1, fp32, depth 2, B={SPINE_B} T={SPINE_T}, 3 "
        f"steps: params' relative L2 {rel:.3e} (bar {SPINE_ACCUM_TOL:g}); "
        f"the steps moved the params by {moved:.3e}")
    check(rel <= SPINE_ACCUM_TOL, f"CausalLM: grad_accum=2 differs by {rel}")
    check(moved > 0, "CausalLM: the accumulation fit did not move")


def spine_mesh_of_one(torch, lm_fit, pm, cfg, p0, batches, ref_flat,
                      step_ms, say) -> float:
    """Part 4: the same fit as part 1 on a data mesh of one rank (NCCL on
    the card), bit for bit; then its captured step timed beside part
    1's ``step_ms`` and profiled.  Returns the NCCL kernels' device ms
    in one step (nan when the profiler reports no device time)."""
    import shutil
    import tempfile

    from deeplearning4j_tpu_torch.ops import updaters

    tmp = tempfile.mkdtemp(prefix="spine-rdv-")
    pm.initialize_distributed(f"file://{tmp}/rdv", 1, 0,
                              device=SPINE_DEVICE)
    try:
        mesh = pm.make_mesh(pm.MeshSpec(data=1))
        lm = spine_lm(lm_fit, cfg, mixed_precision="bf16")
        lm.params = updaters.tree_map(torch.clone, p0)
        t0 = time.perf_counter()
        lm.fit_backprop(batches, num_epochs=SPINE_EPOCHS, mesh=mesh)
        spine_sync(torch)
        wall = time.perf_counter() - t0
        flat = lm.params_flat()
        same = torch.equal(flat, ref_flat)
        diff = float((flat - ref_flat).abs().max())
        say(f"data mesh of one ({mesh.backend}, {mesh!r}), the part-1 fit: "
            f"params equal to mesh=None bit for bit: {same} (largest "
            f"difference {diff:g}); fit wall {wall:.2f} s with its capture; "
            f"the all-reduce is captured inside the step's CUDA graph")
        check(same, f"CausalLM: the mesh of one differs from mesh=None by "
                    f"{diff}")
        step, _ = lm._backprop_machinery(mesh)
        held = list(spine_state(torch, step, lm.params,
                                batches[0].features))

        def one():
            held[0], held[1], held[2], _, _ = step(*held, None)

        one()
        spine_sync(torch)
        t0 = time.perf_counter()
        for _ in range(SPINE_MESH_TIMED):
            one()
        spine_sync(torch)
        mesh_ms = (time.perf_counter() - t0) / SPINE_MESH_TIMED * 1e3
        kinds, by = spine_profile(torch, "mesh-of-one CausalLM", one,
                                  mesh_ms, say)
        nccl_kernels = [k for k in by if "nccl" in k.lower()]
        nccl = kinds.get("NCCL", 0.0) if by else float("nan")
        say(f"mesh-of-one step {mesh_ms:.2f} ms against mesh=None's "
            f"{step_ms:.2f} ms (host clock, {SPINE_MESH_TIMED} synchronized "
            f"replays); NCCL kernels in its profile: {len(nccl_kernels)}, "
            f"{nccl:.3f} ms of device time (an in-place all-reduce over "
            f"one rank has nothing to move)")
        del held, step
        return nccl
    finally:
        torch.distributed.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def spine_moe(torch, fa, moe, lm_fit, ex, say):
    """Part 5: the MoE CausalLM at GPT-2 small's widths, bf16."""
    from deeplearning4j_tpu_torch.ops import flash_attention as fa_mod
    from deeplearning4j_tpu_torch.ops import updaters
    from deeplearning4j_tpu_torch.runtime.metrics import compile_metrics

    cfg = moe_config(moe)
    ids = spine_ids(cfg.vocab_size, SPINE_MOE_BATCHES, SPINE_B, SPINE_T,
                    seed=5)
    batches = spine_batches(ids)
    lm = spine_lm(lm_fit, cfg, mixed_precision="bf16").init(5)
    p0 = updaters.tree_map(torch.clone, lm.params)
    lm.fit_backprop(batches[:1])                      # the warm-up
    lm.params = p0
    log = ScoreLog()
    lm.listeners = [log]
    c0 = compile_metrics.compile_count
    fa.reset_launches()
    t0 = time.perf_counter()
    lm.fit_backprop(batches, num_epochs=SPINE_MOE_EPOCHS)
    spine_sync(torch)
    wall = time.perf_counter() - t0
    counts = fa.launch_counts()
    caps = compile_metrics.compile_count - c0
    lm.listeners = []
    steps = SPINE_MOE_BATCHES * SPINE_MOE_EPOCHS
    losses = np.array(log.seen).reshape(SPINE_MOE_EPOCHS, SPINE_MOE_BATCHES)
    x = torch.as_tensor(ids[0]).to(SPINE_DEVICE)
    _, _, aux, dropped = routing_census(torch, moe, ex, cfg, lm.params, x,
                                        fa_mod.make_attn_fn("auto"))
    choices = cfg.n_layers * x.numel() * cfg.top_k
    step_ms = wall / steps * 1e3
    say(f"MoE CausalLM at GPT-2 small's widths, bf16 mixed precision, "
        f"B={SPINE_B} T={SPINE_T}, {SPINE_MOE_BATCHES} batches x "
        f"{SPINE_MOE_EPOCHS} epochs: losses by epoch "
        + " | ".join(" ".join(f"{v:.4f}" for v in row) for row in losses)
        + f"; step {step_ms:.2f} ms (fit wall / {steps}); mean aux loss "
          f"{aux:.5f}, choices dropped at capacity {dropped} of {choices}; "
          f"guard skips {lm.guard_skips}; captures in the fit {caps}; "
          f"launches {counts}")
    check(np.isfinite(losses).all(), f"MoE CausalLM: non-finite loss "
                                     f"{losses}")
    check(losses[-1].mean() < losses[0].mean(),
          f"MoE CausalLM: the loss did not fall {losses}")
    check(caps == 0, f"MoE CausalLM: {caps} captures after the warm-up")
    expect = launches_per_step(cfg)
    for name, n in counts.items():
        check(n == expect[name] * steps,
              f"MoE CausalLM: {name} = {n}, not {expect[name]} per step")
    return counts


def spine_bn_conf(tconf, accum: int):
    """A ResNet-style MultiLayerNetwork: conv 3x3x8 -> batch norm ->
    conv 3x3x8 -> batch norm -> softmax 10, NHWC 28x28x1."""
    C, K = tconf.NeuralNetConfiguration, tconf.LayerKind

    def conv(n_ch):
        return (C.builder().kind(K.CONVOLUTION).n_channels(n_ch)
                .n_filters(8).kernel_size((3, 3)).stride((1, 1))
                .padding("SAME").activation("relu").lr(0.1)
                .use_adagrad(False).compute_dtype("float32").build())

    def bn():
        return (C.builder().kind(K.BATCH_NORM).n_in(8).n_out(8).lr(0.1)
                .use_adagrad(False).compute_dtype("float32").build())

    out = (C.builder().kind(K.OUTPUT).n_in(28 * 28 * 8).n_out(10)
           .activation("softmax").loss_function("mcxent").lr(0.1)
           .use_adagrad(False).compute_dtype("float32").build())
    return tconf.MultiLayerConfiguration(
        confs=[conv(1), bn(), conv(8), bn(), out],
        input_preprocessors={4: {"name": "flatten"}}, pretrain=False,
        backprop=True, grad_accum=accum)


def spine_lenet(torch, ln, say) -> None:
    """Part 6: MultiLayerNetwork's data-parallel bundle, card against
    CPU: LeNet with bf16 mixed precision and with grad_accum=2 (phase
    9's conf and seeded batches), and batch norm's running statistics
    of a ResNet-style conf through the bundle."""
    from deeplearning4j_tpu_torch.nn.conf import configuration as tconf
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.optimize.listeners import \
        CollectScoresListener

    params = ln.lenet(device="cpu").params
    batches = lenet_random_batches(SPINE_LENET_BATCHES)
    for what, field, value, tol in (
            ("bf16 mixed precision", "mixed_precision", "bf16",
             LENET_LOSS_RTOL["bfloat16"]),
            ("grad_accum=2, fp32", "grad_accum", 2,
             LENET_LOSS_RTOL["float32"])):
        losses = []
        for dev in (SPINE_DEVICE, "cpu"):
            conf = ln.lenet_conf(compute_dtype="float32")
            setattr(conf, field, value)
            net = MultiLayerNetwork(conf, params=[
                {k: v.to(dev) for k, v in p.items()} for p in params],
                device=dev)
            col = CollectScoresListener()
            net.set_listeners([col])
            net.fit_backprop(batches)
            losses.append(np.array([v for _, v in col.scores]))
        rel = float(np.max(np.abs(losses[0] - losses[1]) / np.abs(losses[1])))
        say(f"LeNet {what}, card against CPU, {len(batches)} steps: losses "
            + " ".join(f"{a:.5f}:{b:.5f}" for a, b in zip(*losses))
            + f"; largest relative difference {rel:.3e} (bar {tol:g})")
        check(np.isfinite(losses[0]).all() and rel <= tol,
              f"LeNet {what}: card and CPU differ by {rel}")

    rng = np.random.default_rng(7)
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    bn_batches = [DataSet(rng.random((SPINE_BN_B, 28, 28, 1),
                                     dtype=np.float32),
                          np.eye(10, dtype=np.float32)[
                              rng.integers(0, 10, SPINE_BN_B)])
                  for _ in range(2)]
    stats = []
    p_cpu = MultiLayerNetwork(spine_bn_conf(tconf, 2), device="cpu").init(3)
    for dev in (SPINE_DEVICE, "cpu"):
        net = MultiLayerNetwork(spine_bn_conf(tconf, 2), params=[
            {k: v.to(dev) for k, v in p.items()} for p in p_cpu.params],
            device=dev)
        net.fit_backprop(bn_batches, num_epochs=2)
        stats.append([net.params[i][k].cpu() for i in (1, 3)
                      for k in ("running_mean", "running_var")])
    rel = max(float((a - b).norm() / b.norm()) for a, b in zip(*stats))
    say(f"batch norm through the data-parallel bundle (grad_accum=2, "
        f"bn_collective's masked moments), depth 2, card against CPU: "
        f"running statistics' largest relative L2 {rel:.3e} (bar "
        f"{LENET_LOSS_RTOL['float32']:g})")
    check(rel <= LENET_LOSS_RTOL["float32"],
          f"batch norm running statistics differ by {rel}")


def spine_resilient(torch, gpt, lm_fit, say) -> None:
    """Part 7: ResilientFit over GPT-2 small bf16: a slice stopped after
    SPINE_RF_KILL steps and resumed against an uninterrupted run."""
    import shutil
    import tempfile

    from deeplearning4j_tpu_torch.runtime import resilience
    from deeplearning4j_tpu_torch.runtime.metrics import (checkpoint_metrics,
                                                          compile_metrics)

    cfg = dataclasses.replace(gpt.gpt_config(), n_layers=SPINE_RF_DEPTH)
    batches = spine_batches(spine_ids(cfg.vocab_size, SPINE_RF_BATCHES,
                                      SPINE_B, SPINE_T, seed=7))
    tmp = tempfile.mkdtemp(prefix="spine-rf-")

    def run(d, **kw):
        lm = spine_lm(lm_fit, cfg, mixed_precision="bf16").init(7)
        rf = resilience.ResilientFit(lm, resilience.ResilienceConfig(
            checkpoint_dir=os.path.join(tmp, d),
            checkpoint_every=SPINE_RF_EVERY, max_to_keep=2, **kw))
        rf.fit(batches, num_epochs=2)
        return lm, rf

    try:
        t0 = time.perf_counter()
        was = checkpoint_metrics.snapshot()
        whole, _ = run("whole")
        now = checkpoint_metrics.snapshot()
        # phase 22 prints these beside its sharded snapshots
        SPINE_SNAPSHOT.update(
            commits=now["snapshots_committed"] - was["snapshots_committed"],
            bytes=now["bytes_written"] - was["bytes_written"],
            write_ms=now["write_ms"] - was["write_ms"])
        resilience.compiled_all_finite(whole.params)   # the restore check
        c0 = compile_metrics.compile_count
        part, rf = run("part", max_steps=SPINE_RF_KILL)
        resumed, rf2 = run("part", resume=True)
        caps = compile_metrics.compile_count - c0
        same = torch.equal(resumed.params_flat(), whole.params_flat())
        say(f"ResilientFit over GPT-2 small CausalLM bf16 at depth "
            f"{cfg.n_layers}, {2 * SPINE_RF_BATCHES} steps, a snapshot every "
            f"{SPINE_RF_EVERY}: slice of {rf.steps_run} steps then resume "
            f"of {rf2.steps_run}: equal to the uninterrupted run bit for "
            f"bit: {same}; captures after the warm-up {caps}; wall "
            f"{time.perf_counter() - t0:.1f} s")
        check(rf.steps_run == SPINE_RF_KILL, "ResilientFit: the slice ran "
                                             f"{rf.steps_run} steps")
        check(same, "ResilientFit: the resumed CausalLM differs from the "
                    "uninterrupted run")
        check(caps == 0, f"ResilientFit: {caps} captures after the warm-up")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def spine_card_vs_cpu(torch, gpt, lm_fit, say) -> None:
    """Part 8: fp32 at depth 2, widths 768 / 12 heads, T=256, 3 steps:
    the kernels on the card against plain attention on the CPU."""
    from deeplearning4j_tpu_torch.ops import updaters

    cfg = dataclasses.replace(gpt.gpt_config(), n_layers=2,
                              compute_dtype="float32", dropout=0.0)
    batches = spine_batches(spine_ids(
        cfg.vocab_size, SPINE_CARD_CPU_STEPS, SPINE_CARD_CPU_B,
        SPINE_CARD_CPU_T, seed=8))
    cpu = lm_fit.CausalLM(cfg, lr=SPINE_LR, momentum=SPINE_MOMENTUM,
                          device="cpu").init(8)
    card = spine_lm(lm_fit, cfg)
    card.params = updaters.tree_map(lambda t: t.to(SPINE_DEVICE), cpu.params)
    p0 = cpu.params_flat()
    logs = []
    for lm in (card, cpu):
        log = ScoreLog()
        lm.listeners = [log]
        lm.fit_backprop(batches)
        logs.append(log.seen)
    a, b = card.params_flat(), cpu.params_flat()
    rel = float((a - b).norm() / b.norm())
    moved = float((b - p0).norm() / p0.norm())
    say(f"CausalLM fp32 depth 2, T={SPINE_CARD_CPU_T}, "
        f"{SPINE_CARD_CPU_STEPS} steps, card (kernels) against CPU (plain "
        f"attention): losses "
        + " ".join(f"{x:.6f}:{y:.6f}" for x, y in zip(*logs))
        + f"; params' relative L2 {rel:.3e} (bar {SPINE_CARD_CPU_TOL:g}); "
          f"the steps moved the params by {moved:.3e}")
    check(rel <= SPINE_CARD_CPU_TOL, f"CausalLM: card and CPU differ by "
                                     f"{rel}")


def spine_phase(torch, fa, card: str) -> dict:
    """Phase 17 (see the module docstring)."""
    from deeplearning4j_tpu_torch.models import gpt, lm_fit, moe
    from deeplearning4j_tpu_torch.models import lenet as ln
    from deeplearning4j_tpu_torch.parallel import expert as ex
    from deeplearning4j_tpu_torch.parallel import mesh as pm
    from deeplearning4j_tpu_torch.parallel import sharded_fit as sf
    from deeplearning4j_tpu_torch.runtime import compile_cache

    def say(msg):
        print(f"  {msg} [{card}]")

    compile_cache.clear()
    if SPINE_DEVICE == "cuda":
        gc_cuda(torch)
    t = [time.perf_counter()]
    counts, cfg, p0, batches, ref_flat, step_ms = spine_gpt(
        torch, fa, gpt, lm_fit, sf, say)
    t.append(time.perf_counter())
    spine_graph_and_guard(torch, gpt, lm_fit, say)
    spine_accum(torch, gpt, lm_fit, say)
    t.append(time.perf_counter())
    nccl = spine_mesh_of_one(torch, lm_fit, pm, cfg, p0, batches, ref_flat,
                             step_ms, say)
    del p0, batches
    compile_cache.clear()
    if SPINE_DEVICE == "cuda":
        gc_cuda(torch)
    t.append(time.perf_counter())
    for name, n in spine_moe(torch, fa, moe, lm_fit, ex, say).items():
        counts[name] += n
    compile_cache.clear()
    if SPINE_DEVICE == "cuda":
        gc_cuda(torch)
    t.append(time.perf_counter())
    fa.reset_launches()
    spine_lenet(torch, ln, say)
    t.append(time.perf_counter())
    spine_resilient(torch, gpt, lm_fit, say)
    compile_cache.clear()
    if SPINE_DEVICE == "cuda":
        gc_cuda(torch)
    t.append(time.perf_counter())
    spine_card_vs_cpu(torch, gpt, lm_fit, say)
    t.append(time.perf_counter())
    names = ("GPT-2 small fit", "graph, guard and accumulation",
             "mesh of one", "MoE", "LeNet and batch norm", "ResilientFit",
             "card vs CPU")
    say("phase 17 wall: " + ", ".join(
        f"{n} {b - a:.1f} s" for n, a, b in zip(names, t, t[1:]))
        + f"; total {t[-1] - t[0]:.1f} s; NCCL in a mesh-of-one step "
          f"{nccl:.3f} ms")
    return counts


# ---------------------------------------------------------------------------
# phase 18: the rest of the MultiLayerNetwork surface
# ---------------------------------------------------------------------------

#: the device phase 18 runs on (a CPU rehearsal substitutes "cpu")
SLICE_DEVICE = "cuda"
#: the char-LSTM at the widths of DL4J's public
#: GravesLSTMCharModellingExample (lstmLayerSize=200, miniBatchSize=32,
#: exampleLength=1000) on data/text8, whose 27 symbols are one-hot in
#: and out; Adam, bf16 products, each time step recomputed in the
#: backward (truncate_bptt)
CHAR_VOCAB = " abcdefghijklmnopqrstuvwxyz"
CHAR_HIDDEN, CHAR_B, CHAR_T = 200, 32, 1000
CHAR_LR, CHAR_STEPS, CHAR_SAMPLE = 2e-3, 5, 200
#: card against CPU at T=50 (depth cut for this check only): loss and
#: gradients' relative L2 with fp32 products; the loss with bf16's
CHAR_CHECK_T, CHAR_FP32_TOL, CHAR_BF16_TOL = 50, 1e-4, 2e-2
#: the LFW accuracy tier of tests/test_jpeg_lfw.py:160-193
LFW_SIZE, LFW_HIDDEN, LFW_LR, LFW_EPOCHS, LFW_MIN_ACC = 28, 48, 0.05, 300, 0.8
#: fit_iterator over NativeBatchIterator trains a fresh net: batches of
#: 20, 100 epochs (a fit's updater state starts anew, and one epoch from
#: the fitted net would undo it: the first AdaGrad steps are lr-sized)
LFW_ITER_BATCH, LFW_ITER_EPOCHS = 20, 100
#: the recursive autoencoder at phase 7's embedding width
RAE_B, RAE_T, RAE_D, RAE_LR, RAE_ITERS, RAE_TOL = 256, 20, 100, 0.05, 30, 1e-4
#: the GraphBuilder docstring graph: card against CPU, then descent
GRAPH_TOL, GRAPH_LR, GRAPH_STEPS = 1e-5, 0.5, 20
#: autotune shapes: (what, B, T, heads, head dim, causal)
TUNE_SHAPES = (("BERT-base training", 32, 128, 12, 64, False),
               ("GPT-2 small training", 8, 1024, 12, 64, True))


def slice_sync(torch) -> None:
    if SLICE_DEVICE == "cuda":
        torch.cuda.synchronize()


def char_batch(text: str, b: int, t: int, seed: int):
    """``b`` windows of ``t + 1`` symbols of ``text`` at seeded offsets:
    one-hot inputs ``[b, t, 27]`` and next-symbol ids ``[b, t]``."""
    table = np.full(256, -1, np.int64)
    for i, ch in enumerate(CHAR_VOCAB):
        table[ord(ch)] = i
    ids = table[np.frombuffer(text.encode(), np.uint8)]
    check(bool((ids >= 0).all()), "data/text8 holds a symbol outside a-z "
                                  "and space")
    starts = np.random.default_rng(seed).integers(0, len(ids) - t - 1, b)
    w = ids[starts[:, None] + np.arange(t + 1)]
    eye = np.eye(len(CHAR_VOCAB), dtype=np.float32)
    return eye[w[:, :-1]], w[:, 1:]


def rel_l2(torch, got, ref) -> float:
    """Global relative L2 of two lists of tensors, on the CPU."""
    num = sum(float(torch.sum((g.cpu().double() - r.cpu().double()) ** 2))
              for g, r in zip(got, ref))
    den = sum(float(torch.sum(r.cpu().double() ** 2)) for r in ref)
    return (num / max(den, 1e-300)) ** 0.5


def char_card_vs_cpu(torch, params, text, say) -> None:
    """One step's loss and gradients at T=CHAR_CHECK_T on the card and on
    the CPU from the same params."""
    from deeplearning4j_tpu_torch.nn.conf.configuration import (
        LayerKind, NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.layers.lstm import LSTMLayer

    xs, ys = char_batch(text, CHAR_B, CHAR_CHECK_T, seed=1)
    got = {}
    for cdt in ("float32", "bfloat16"):
        conf = (NeuralNetConfiguration.builder().kind(LayerKind.LSTM)
                .n_in(27).n_out(27).hidden_size(CHAR_HIDDEN)
                .activation("softmax").truncate_bptt(1)
                .compute_dtype(cdt).build())
        layer = LSTMLayer(conf)
        for dev in (SLICE_DEVICE, "cpu"):
            p = {k: v.detach().to(dev).requires_grad_(True)
                 for k, v in params.items()}
            x = torch.from_numpy(xs).to(dev)
            y = torch.nn.functional.one_hot(torch.from_numpy(ys).to(dev),
                                            27).float()
            loss = layer.sequence_loss(p, x, y)
            grads = torch.autograd.grad(loss, [p[k] for k in sorted(p)])
            got[cdt, dev] = (float(loss.detach()), [g.cpu() for g in grads])
    (l_card, g_card), (l_cpu, g_cpu) = (got["float32", SLICE_DEVICE],
                                        got["float32", "cpu"])
    loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
    grad_rel = rel_l2(torch, g_card, g_cpu)
    bf16_rel = (abs(got["bfloat16", SLICE_DEVICE][0]
                    - got["bfloat16", "cpu"][0])
                / abs(got["bfloat16", "cpu"][0]))
    say(f"(a) card vs CPU at T={CHAR_CHECK_T}, fp32 products: loss "
        f"{l_card:.7f} / {l_cpu:.7f} (rel {loss_rel:.3e}), gradients' "
        f"relative L2 {grad_rel:.3e} (tolerance {CHAR_FP32_TOL}); bf16 "
        f"products: loss {got['bfloat16', SLICE_DEVICE][0]:.7f} / "
        f"{got['bfloat16', 'cpu'][0]:.7f} (rel {bf16_rel:.3e}, tolerance "
        f"{CHAR_BF16_TOL})")
    check(loss_rel <= CHAR_FP32_TOL and grad_rel <= CHAR_FP32_TOL,
          f"char-LSTM fp32 step: card and CPU disagree ({loss_rel:.3e}, "
          f"{grad_rel:.3e})")
    check(bf16_rel <= CHAR_BF16_TOL,
          f"char-LSTM bf16 loss: card and CPU disagree ({bf16_rel:.3e})")


def char_lstm(torch, say) -> None:
    """(a): the char-LSTM's fit, sampling and card-vs-CPU step."""
    from deeplearning4j_tpu_torch.nn.api import LSTMSequenceClassifier

    with open(TEXT8) as f:
        text = f.read()
    xs, ys = char_batch(text, CHAR_B, CHAR_T, seed=0)
    clf = LSTMSequenceClassifier(
        len(CHAR_VOCAB), len(CHAR_VOCAB), hidden=CHAR_HIDDEN,
        learning_rate=CHAR_LR, seed=0, truncate_bptt=1,
        compute_dtype="bfloat16", device=SLICE_DEVICE)
    t0 = time.perf_counter()
    losses = clf.fit(xs, ys, epochs=1)      # warm-up runs, capture, replay
    slice_sync(torch)
    t1 = time.perf_counter()
    losses += clf.fit(xs, ys, epochs=CHAR_STEPS)
    slice_sync(torch)
    t2 = time.perf_counter()
    step_ms = (t2 - t1) / CHAR_STEPS * 1e3
    graphs = clf._train_step.signatures()
    how = (f"captured ({graphs} CUDA graph(s) of the whole step)"
           if SLICE_DEVICE == "cuda" else "eager (CPU)")
    say(f"(a) char-LSTM B={CHAR_B} T={CHAR_T} H={CHAR_HIDDEN}, vocab "
        f"{len(CHAR_VOCAB)}, bf16, truncate_bptt on, Adam lr {CHAR_LR}: "
        f"first step {(t1 - t0) * 1e3:.1f} ms (warm-up and capture), then "
        f"{step_ms:.3f} ms a step, "
        f"{CHAR_B * CHAR_T / (step_ms / 1e3):,.1f} characters/s over "
        f"{CHAR_STEPS} steps; {how}; losses "
        + ", ".join(f"{v:.4f}" for v in losses))
    check(all(np.isfinite(losses)), f"char-LSTM loss not finite: {losses}")
    check(losses[-1] < losses[0], f"char-LSTM loss did not fall: {losses}")
    check(SLICE_DEVICE != "cuda" or graphs >= 1,
          "the char-LSTM step was not captured")
    gen = torch.Generator(device=SLICE_DEVICE).manual_seed(0)
    t0 = time.perf_counter()
    ids = clf.classifier().sample(clf.params, gen, CHAR_SAMPLE,
                                  start_id=CHAR_VOCAB.index("t"))
    ids = ids.tolist()
    ms = (time.perf_counter() - t0) * 1e3
    check(len(ids) == CHAR_SAMPLE
          and all(0 <= i < len(CHAR_VOCAB) for i in ids),
          f"char-LSTM sample: bad ids {ids[:20]}")
    say(f"(a) sample of {CHAR_SAMPLE} characters in {ms:.1f} ms: "
        f"{''.join(CHAR_VOCAB[i] for i in ids)!r}")
    char_card_vs_cpu(torch, clf.params, text, say)


def lfw_native(torch, say) -> None:
    """(b): LFW through the native JPEG decode, the accuracy tier and
    one epoch of NativeBatchIterator."""
    from deeplearning4j_tpu_torch.datasets.fetchers import (LFWDataFetcher,
                                                            find_lfw)
    from deeplearning4j_tpu_torch.datasets.iterator import \
        NativeBatchIterator
    from deeplearning4j_tpu_torch.nn.conf.configuration import (
        LayerKind, NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.runtime import native

    t0 = time.perf_counter()
    ok = native.available()
    build_s = time.perf_counter() - t0
    check(ok, f"the native library did not build:\n{native.build_error}")
    t0 = time.perf_counter()
    f = LFWDataFetcher(image_size=LFW_SIZE)
    decode_ms = (time.perf_counter() - t0) * 1e3
    n, dim = f.features.shape
    check(not f.synthetic and n == 120 and dim == LFW_SIZE * LFW_SIZE,
          f"LFW: synthetic={f.synthetic}, features {f.features.shape}")
    f.fetch(n)
    ds = f.next().normalize_zero_mean_unit_variance()
    k = f.labels.shape[1]
    conf = (NeuralNetConfiguration.builder()
            .n_in(dim).lr(LFW_LR).activation("relu").list(2)
            .hidden_layer_sizes(LFW_HIDDEN)
            .override(1, kind=LayerKind.OUTPUT, n_out=k,
                      activation="softmax", loss_function="mcxent")
            .pretrain(False).backward(True).build())
    net = MultiLayerNetwork(conf, device=SLICE_DEVICE).init()
    t0 = time.perf_counter()
    net.fit_backprop([ds], num_epochs=LFW_EPOCHS)
    slice_sync(torch)
    train_s = time.perf_counter() - t0
    acc = net.evaluate(ds).accuracy()
    net2 = MultiLayerNetwork(conf, device=SLICE_DEVICE).init()
    it = NativeBatchIterator(np.asarray(ds.features), np.asarray(ds.labels),
                             batch_size=LFW_ITER_BATCH, seed=0,
                             device=SLICE_DEVICE)
    try:
        check(it.uses_native, "NativeBatchIterator is not on the native "
                              "producer")
        t0 = time.perf_counter()
        net2.fit_iterator(it, num_epochs=1)
        slice_sync(torch)
        t1 = time.perf_counter()
        net2.fit_iterator(it, num_epochs=LFW_ITER_EPOCHS - 1)
        slice_sync(torch)
        t2 = time.perf_counter()
    finally:
        it.close()
    acc_iter = net2.evaluate(ds).accuracy()
    say(f"(b) native library {native.library_path().name} ready in "
        f"{build_s:.1f} s; LFW {find_lfw()}: {n} JPEGs of {k} people "
        f"decoded and resized to {LFW_SIZE}x{LFW_SIZE} in {decode_ms:.1f} "
        f"ms; {dim}-{LFW_HIDDEN}-{k} relu, lr {LFW_LR}, {LFW_EPOCHS} epochs "
        f"of fit_backprop in {train_s:.2f} s: accuracy {acc:.4f}; "
        f"fit_iterator over NativeBatchIterator (native producer, batch "
        f"{LFW_ITER_BATCH}, {it.batches_per_epoch} batches an epoch) on a "
        f"fresh net: first epoch {(t1 - t0) * 1e3:.1f} ms (with its "
        f"capture), then {(t2 - t1) / (LFW_ITER_EPOCHS - 1) * 1e3:.2f} ms "
        f"an epoch; accuracy after {LFW_ITER_EPOCHS} epochs {acc_iter:.4f}")
    check(acc_iter > LFW_MIN_ACC, f"LFW accuracy through "
                                  f"NativeBatchIterator {acc_iter:.4f}")
    check(acc > LFW_MIN_ACC, f"LFW accuracy {acc:.4f} <= {LFW_MIN_ACC}")


def recursive_ae(torch, say) -> None:
    """(c): the recursive autoencoder's pretraining and a card-vs-CPU
    value and gradient."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.nn.conf.configuration import (
        LayerKind, NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf = (NeuralNetConfiguration.builder()
            .kind(LayerKind.RECURSIVE_AUTOENCODER).n_in(RAE_D).n_out(RAE_D)
            .activation("tanh").lr(RAE_LR).num_iterations(RAE_ITERS)
            .compute_dtype("float32").list(1).pretrain(True)
            .backward(False).build())
    net = MultiLayerNetwork(conf, device=SLICE_DEVICE).init()
    layer = net.layers[0]
    x = np.random.default_rng(0).normal(
        0.0, 0.5, (RAE_B, RAE_T, RAE_D)).astype(np.float32)
    xd = torch.from_numpy(x).to(SLICE_DEVICE)
    p0 = {k: v.clone() for k, v in net.params[0].items()}
    card = layer.pretrain_value_and_grad(p0, None, xd)
    cpu = layer.pretrain_value_and_grad(
        {k: v.cpu() for k, v in p0.items()}, None, torch.from_numpy(x))
    keys = sorted(card[1])
    loss_rel = abs(float(card[0]) - float(cpu[0])) / abs(float(cpu[0]))
    grad_rel = rel_l2(torch, [card[1][k] for k in keys],
                      [cpu[1][k] for k in keys])
    with torch.no_grad():
        before = float(layer.fold(net.params[0], xd)[1])
    t0 = time.perf_counter()
    net.pretrain(DataSet(x, x))
    slice_sync(torch)
    pre_ms = (time.perf_counter() - t0) * 1e3
    with torch.no_grad():
        after = float(layer.fold(net.params[0], xd)[1])
    say(f"(c) recursive autoencoder B={RAE_B} T={RAE_T} D={RAE_D}: "
        f"reconstruction loss {before:.6f} -> {after:.6f} after "
        f"{RAE_ITERS} pretrain steps (lr {RAE_LR}) in {pre_ms:.1f} ms; "
        f"card vs CPU pretrain_value_and_grad: loss rel {loss_rel:.3e}, "
        f"gradients' relative L2 {grad_rel:.3e} (tolerance {RAE_TOL})")
    check(np.isfinite(after) and after < before,
          f"recursive AE pretraining did not lower the loss: {before} -> "
          f"{after}")
    check(loss_rel <= RAE_TOL and grad_rel <= RAE_TOL,
          f"recursive AE card vs CPU: {loss_rel:.3e}, {grad_rel:.3e}")


def graph_builder(torch, say) -> None:
    """(d): the GraphBuilder docstring graph on the card against the CPU,
    then a few gradient steps."""
    from deeplearning4j_tpu_torch.ops.graph import GraphBuilder

    rng = np.random.default_rng(0)
    w0 = rng.normal(size=(4, 2)).astype(np.float32)
    xs = rng.normal(size=(8, 4)).astype(np.float32)
    ts = rng.normal(size=(8, 2)).astype(np.float32)

    def build(dev):
        g = GraphBuilder(device=dev)
        x = g.placeholder("x", (8, 4))
        w = g.variable("w", w0)
        b = g.variable("b", np.zeros(2, np.float32))
        y = g.softmax(g.add(g.matmul(x, w), b))
        loss = g.mean(g.square(g.sub(y, g.placeholder("t", (8, 2)))))
        return g, loss

    got = {}
    for dev in (SLICE_DEVICE, "cpu"):
        g, loss = build(dev)
        got[dev] = (float(g.compile(loss)(x=xs, t=ts)),
                    {k: v.cpu() for k, v in g.grad(loss)(x=xs, t=ts).items()})
    val_rel = (abs(got[SLICE_DEVICE][0] - got["cpu"][0])
               / abs(got["cpu"][0]))
    grad_rel = rel_l2(torch, [got[SLICE_DEVICE][1][k] for k in "bw"],
                      [got["cpu"][1][k] for k in "bw"])
    g, loss = build(SLICE_DEVICE)
    f, gradfn = g.compile(loss), g.grad(loss)
    first = float(f(x=xs, t=ts))
    for _ in range(GRAPH_STEPS):
        grads = gradfn(x=xs, t=ts)
        for name, gr in grads.items():
            g.set_variable(name, g.variables[name] - GRAPH_LR * gr)
    last = float(f(x=xs, t=ts))
    say(f"(d) GraphBuilder: compile {got[SLICE_DEVICE][0]:.7f} / CPU "
        f"{got['cpu'][0]:.7f} (rel {val_rel:.3e}), grad relative L2 "
        f"{grad_rel:.3e} (tolerance {GRAPH_TOL}); {GRAPH_STEPS} steps at "
        f"lr {GRAPH_LR}: loss {first:.6f} -> {last:.6f}; fx graph of "
        f"{g.fx_graph(loss).count(chr(10))} lines")
    check(val_rel <= GRAPH_TOL and grad_rel <= GRAPH_TOL,
          f"GraphBuilder card vs CPU: {val_rel:.3e}, {grad_rel:.3e}")
    check(last < first, f"GraphBuilder descent: {first} -> {last}")


#: run in a fresh process over the sweep's cache: each shape's lookup and
#: make_attn_fn's decision, and the process's sweep count
AUTOTUNE_PROBE = """
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
from deeplearning4j_tpu_torch.ops.flash_attention import make_attn_fn
from deeplearning4j_tpu_torch.runtime import autotune as at
from deeplearning4j_tpu_torch.runtime.metrics import mfu_metrics
rows = []
for B, T, NH, D, causal in json.loads(sys.argv[3]):
    rec = at.lookup_attention(T, T, D, causal, rows=B * NH,
                              kind=at.device_kind(sys.argv[2]))
    d = make_attn_fn(autotune=True).describe((B, T, NH, D), (B, T, NH, D), causal,
                                device=sys.argv[2], dtype=torch.bfloat16)
    rows.append([rec["impl"] if rec else None, d.impl, d.source])
print(json.dumps({"rows": rows, "sweeps": mfu_metrics.count("sweeps"),
                  "cache_hits": mfu_metrics.count("cache_hits")}))
"""


def autotune_part(torch, say) -> None:
    """(e): the attention sweep at BERT-base's and GPT-2 small's training
    shapes into a temporary cache, then a fresh process that finds both
    winners without sweeping."""
    import shutil
    import tempfile

    from deeplearning4j_tpu_torch.runtime import autotune as at
    from deeplearning4j_tpu_torch.runtime.metrics import mfu_metrics

    tmp = tempfile.mkdtemp(prefix="chip_smoke_autotune_")
    os.environ[at.AUTOTUNE_CACHE_ENV] = tmp
    at.reset_memo()
    mfu_metrics.reset()
    try:
        winners = []
        for what, B, T, NH, D, causal in TUNE_SHAPES:
            rec = at.sweep_attention(T, T, D, causal, batch=B, n_heads=NH,
                                     dtype=torch.bfloat16,
                                     device=SLICE_DEVICE)
            c = rec["candidates"]
            winners.append(rec["impl"])
            say(f"(e) autotune {what} B={B} T={T} heads={NH} D={D} "
                f"{'causal' if causal else 'full'} bf16, fwd+bwd: "
                + ", ".join(f"{n} {c[n].get('step_ms', c[n].get('error'))}"
                            + (" ms" if "step_ms" in c[n] else "")
                            for n in c)
                + f"; winner {rec['impl']} ({rec['blocks']})")
            check(set(c) <= {"plain", "cuda"},
                  f"a library attention was a candidate: {sorted(c)}")
            check(SLICE_DEVICE != "cuda" or "cuda" in c,
                  f"the kernel was not timed at {what}")
        check(mfu_metrics.count("sweeps") == len(TUNE_SHAPES),
              f"sweeps {mfu_metrics.count('sweeps')}")
        shapes = json.dumps([s[1:] for s in TUNE_SHAPES])
        proc = subprocess.run(
            [sys.executable, "-c", AUTOTUNE_PROBE, REPO, SLICE_DEVICE,
             shapes], capture_output=True, text=True, timeout=300,
            env=dict(os.environ))
        check(proc.returncode == 0,
              f"autotune probe failed:\n{proc.stderr[-3000:]}")
        probe = json.loads(proc.stdout.strip().splitlines()[-1])
        say(f"(e) a fresh process on the same cache: {probe}")
        # each shape is consulted twice there: lookup_attention, then
        # make_attn_fn's describe
        check(probe["sweeps"] == 0
              and probe["cache_hits"] == 2 * len(TUNE_SHAPES),
              f"the warmed process swept or missed: {probe}")
        for (looked, impl, source), won in zip(probe["rows"], winners):
            check(looked == won and impl == won and source == "autotuned",
                  f"make_attn_fn did not follow the cached winner: "
                  f"{probe['rows']} against {winners}")
    finally:
        os.environ[at.AUTOTUNE_CACHE_ENV] = "off"
        at.reset_memo()
        shutil.rmtree(tmp, ignore_errors=True)


def slice_phase(torch, fa, fw, fg, card: str) -> None:
    """Phase 18 (see the module docstring)."""
    from deeplearning4j_tpu_torch.runtime import compile_cache

    def say(msg):
        print(f"  {msg} [{card}]")

    compile_cache.clear()
    if SLICE_DEVICE == "cuda":
        gc_cuda(torch)
    for mod in (fa, fw, fg):
        mod.reset_launches()
    t = [time.perf_counter()]
    for part in (char_lstm, lfw_native, recursive_ae, graph_builder):
        part(torch, say)
        t.append(time.perf_counter())
    hand = {**fa.launch_counts(), "w2v": fw.launches, "glove": fg.launches}
    say(f"hand-kernel launches during (a)-(d): {hand} (no TPU kernel lies "
        f"on these paths)")
    check(not any(hand.values()), f"a hand kernel ran during phase 18 "
                                  f"(a)-(d): {hand}")
    autotune_part(torch, say)
    t.append(time.perf_counter())
    names = ("char-LSTM", "LFW", "recursive AE", "GraphBuilder", "autotune")
    say("phase 18 wall: " + ", ".join(
        f"{n} {b - a:.1f} s" for n, a, b in zip(names, t, t[1:]))
        + f"; total {t[-1] - t[0]:.1f} s")


# ---------------------------------------------------------------------------
# phase 19: the model axis, two ranks on one card
# ---------------------------------------------------------------------------

#: the device phase 19 runs on (a CPU rehearsal substitutes "cpu")
MA_DEVICE = "cuda"
#: (b) GPT-2 small at depth 2 in fp32 and (c) at full depth in bf16
#: mixed precision: B=8 T=1024, SGD lr 0.05; (b) takes 3 seeded batches
#: once, (c) one batch 3 times (its loss must fall)
MA_B, MA_T, MA_STEPS, MA_LR, MA_DEPTH_FP32 = 8, 1024, 3, 0.05, 2
#: (d) 4 prompts, 16 greedy tokens each, fp32, one bucket of 64
MA_PROMPTS, MA_TOKENS, MA_BUCKET = 4, 16, 64
#: (e) BERT-base MLM, bf16, dropout 0: B=32 T=128, 2 steps
MA_BERT_B, MA_BERT_T, MA_BERT_STEPS = 32, 128, 2
#: tolerances: (b) gathered params, relative L2; (c) per-step losses;
#: (e) loss and gradients, relative L2
MA_PARAMS_TOL, MA_LOSS_TOL, MA_BERT_TOL = 1e-5, 2e-2, 3e-2
#: (c) the change of the gathered params over the 3 steps against
#: mesh=None's, relative L2 of the difference to mesh=None's change, read
#: apart over the model-split leaves and over the replicated ones: the
#: limit lies between the sound runs' readings (3.5e-3 / 2.9e-3 on the
#: H100) and the two controls' (the split leaves left at their init,
#: 1.0; a run whose column-parallel inputs' gradients skip their sum
#: over model, 0.44 / 0.44); PERF.md records them
MA_DELTA_TOL = 3e-2
#: what a rank's share of GPT-2 small's params may be of the replicated
MA_SHARE_MAX = 0.70
#: seconds the two ranks may take
MA_DEADLINE_S = 900.0
#: B1-B3 at a rank's shapes: 6 of GPT-2 small's 12 heads, B=8 T=1024
MA_KERNEL_CASES = [
    ("GPT-2 small, one rank's 6 heads, fp32", 8, 6, 1024, 1024, 64,
     "float32", True, None),
    ("GPT-2 small, one rank's 6 heads, bf16", 8, 6, 1024, 1024, 64,
     "bfloat16", True, None),
]


def ma_settings() -> dict:
    """What the rank processes need to know of this run (a spawned
    process does not see a rehearsal's changes to this module)."""
    return {"device": MA_DEVICE, "B": MA_B, "T": MA_T, "steps": MA_STEPS,
            "lr": MA_LR, "depth": MA_DEPTH_FP32, "prompts": MA_PROMPTS,
            "tokens": MA_TOKENS, "bucket": MA_BUCKET, "bert_B": MA_BERT_B,
            "bert_T": MA_BERT_T, "bert_steps": MA_BERT_STEPS,
            "gpt": None, "bert": None}


def ma_configs(gpt, bert, st):
    """(GPT fp32 at (b)'s depth, GPT bf16 at full depth, GPT fp32 for
    decoding, BERT-base bf16 without dropout)."""
    base = gpt.gpt_config() if st["gpt"] is None else st["gpt"]
    fp32 = dataclasses.replace(base, compute_dtype="float32")
    shallow = dataclasses.replace(fp32, n_layers=st["depth"])
    bcfg = bert.bert_base() if st["bert"] is None else st["bert"]
    return (shallow, dataclasses.replace(base, compute_dtype="bfloat16"),
            fp32, dataclasses.replace(bcfg, dropout=0.0))


def ma_ids(vocab: int, n: int, b: int, t: int, seed: int):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (b, t), dtype=np.int32) for _ in range(n)]


def ma_prompts(vocab: int, n: int):
    rng = np.random.default_rng(19)
    return [rng.integers(0, vocab, int(rng.integers(8, 33)), dtype=np.int32)
            for _ in range(n)]


def ma_flat(torch, tree):
    """Every leaf as one fp32 CPU vector, dict keys sorted."""
    from deeplearning4j_tpu_torch.models import lm_fit
    return torch.cat([t.detach().reshape(-1).float().cpu()
                      for t in lm_fit._sorted_leaves(tree)])


def ma_rel(torch, got, ref) -> float:
    return float((got - ref).norm() / ref.norm().clamp_min(1e-30))


class MaLog:
    def __init__(self):
        self.seen = []

    def iteration_done(self, model, i, score):
        self.seen.append(float(score))


def ma_sync(torch, st) -> None:
    if st["device"] == "cuda":
        torch.cuda.synchronize()


def ma_references(torch, st, tmp: str) -> dict:
    """The mesh=None runs, in this process on the card: written to
    ``tmp`` for the ranks to hold theirs against."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.models import bert, gpt, lm_fit
    from deeplearning4j_tpu_torch.models import transformer as tfm
    from deeplearning4j_tpu_torch.ops.flash_attention import make_attn_fn
    from deeplearning4j_tpu_torch.serving.decode import DecodeEngine

    dev = st["device"]
    shallow, deep, fp32, bcfg = ma_configs(gpt, bert, st)
    out = {}
    lm = lm_fit.CausalLM(shallow, lr=st["lr"], device=dev).init(0)
    log = MaLog()
    lm.listeners = [log]
    ids = ma_ids(shallow.vocab_size, st["steps"], st["B"], st["T"], 0)
    lm.fit_backprop([DataSet(x, x) for x in ids], num_epochs=1)
    torch.save(lm.params_flat(), os.path.join(tmp, "b_flat.pt"))
    out["b_losses"] = log.seen
    del lm
    lm = lm_fit.CausalLM(deep, lr=st["lr"], mixed_precision="bf16",
                         device=dev).init(0)
    log = MaLog()
    lm.listeners = [log]
    one = ma_ids(deep.vocab_size, 1, st["B"], st["T"], 1)
    ma_sync(torch, st)
    t0 = time.perf_counter()
    lm.fit_backprop([DataSet(x, x) for x in one], num_epochs=st["steps"])
    ma_sync(torch, st)
    out["c_step_ms"] = (time.perf_counter() - t0) / st["steps"] * 1e3
    out["c_losses"] = log.seen
    torch.save(lm.params_flat(), os.path.join(tmp, "c_flat.pt"))
    del lm
    params = gpt.init_params(torch.Generator(device=dev).manual_seed(1),
                             fp32, dev)
    eng = DecodeEngine(fp32, params, n_slots=st["prompts"],
                       buckets=(st["bucket"],), prefill_chunk=16, device=dev)
    out["d_tokens"] = ma_decode(eng, ma_prompts(fp32.vocab_size,
                                                st["prompts"]), st["tokens"])
    out["d_kv"] = eng.kv_bytes_per_slot
    del eng, params
    params = bert.init_params(torch.Generator(device=dev).manual_seed(2),
                              bcfg, dev)
    batch = bert.synthetic_batch(5, bcfg, st["bert_B"], st["bert_T"],
                                 device=dev)
    attn = make_attn_fn("auto")
    loss, grads = tfm.value_and_grad(
        lambda p: bert.mlm_loss(bcfg, p, batch, None, attn), params)
    torch.save(ma_flat(torch, grads), os.path.join(tmp, "e_grads.pt"))
    out["e_loss"] = float(loss)
    _, step = bert.make_train_step(bcfg, device=dev)
    from deeplearning4j_tpu_torch.ops import updaters
    state = tfm.TrainState(params, updaters.adamw(1e-4, weight_decay=0.01)
                           .init(params), 0)
    losses = []
    for _ in range(st["bert_steps"]):
        state, l_ = step(state, batch)
        losses.append(float(l_))
    out["e_losses"] = losses
    return out


def ma_decode(eng, prompts, n: int):
    """Every prompt started in a slot of the engine's one bucket, then
    the bucket advanced until each has ``n`` greedy tokens."""
    placed = []
    for p in prompts:
        bucket, slot, first = eng.start(p, max_tokens=n, temperature=0.0,
                                        seed=0)
        placed.append((bucket, slot, [int(first)]))
    bucket = placed[0][0]
    for _ in range(n - 1):
        toks = eng.advance(bucket)
        for _, slot, seen in placed:
            seen.append(int(toks[slot]))
    for b, slot, _ in placed:
        eng.release(b, slot)
    return [seen for _, _, seen in placed]


def ma_nccl_probe(rank: int, rdv: str, out: str) -> None:
    """Rank ``rank`` of a two-rank NCCL group on card 0: what NCCL says."""
    import torch
    import torch.distributed as dist
    try:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=f"file://{rdv}",
                                world_size=2, rank=rank,
                                device_id=torch.device("cuda", 0))
        x = torch.ones(4, device="cuda")
        dist.all_reduce(x)
        torch.cuda.synchronize()
        msg = f"ok: all_reduce gave {x.tolist()}"
    except Exception as e:  # noqa: BLE001 — the error is the result
        msg = f"{type(e).__name__}: {e}"
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(out, "w") as f:
        f.write(msg)


def ma_spawn(target, tmp: str, tag: str, args=(), phase: int = 19) -> list:
    """``target(rank, rdv, out, *args)`` in two spawned processes; their
    outputs (files), or a failure if a rank dies or outlives the
    deadline."""
    return ma_join(ma_start(target, tmp, tag, args), tag, phase)


def ma_start(target, tmp: str, tag: str, args=(), world: int = 2):
    """The ``world`` processes of :func:`ma_spawn`, started: ``(processes,
    output files, deadline)`` for :func:`ma_join`, so this process can
    work while the ranks start up."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    rdv = os.path.join(tmp, f"rdv-{tag}")
    outs = [os.path.join(tmp, f"{tag}-{r}.out") for r in range(world)]
    procs = [ctx.Process(target=target, args=(r, rdv, outs[r]) + tuple(args))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs, outs, time.monotonic() + MA_DEADLINE_S


def ma_join(started, tag: str, phase: int = 19, dies=None) -> list:
    """The outputs of :func:`ma_start`'s processes, or a failure naming
    every rank that died, failed or outlived the deadline.  ``dies`` maps
    a rank expected to die to its exit code (-9: SIGKILL); its result is
    None, and any other end of it fails."""
    import pickle

    dies = dies or {}
    procs, outs, deadline = started
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    check(not hung, f"phase {phase} {tag}: ranks {hung} still running "
                    f"after {MA_DEADLINE_S} s: killed")
    results = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        if r in dies:
            check(p.exitcode == dies[r] and not os.path.exists(out),
                  f"phase {phase} {tag}: rank {r} was to die with "
                  f"{dies[r]}, but exited with {p.exitcode}")
            results.append(("ok", None))
            continue
        check(os.path.exists(out), f"phase {phase} {tag}: rank {r} exited "
                                   f"with {p.exitcode} and no result")
        if tag == "nccl":
            with open(out) as f:
                results.append(f.read())
            continue
        with open(out, "rb") as f:
            results.append(pickle.load(f))
    if tag == "nccl":
        return results
    failed = [f"rank {r} failed:\n{value}"
              for r, (status, value) in enumerate(results) if status != "ok"]
    # every failed rank's error: the first to fail is not always rank 0
    check(not failed, f"phase {phase} {tag}: " + "\n".join(failed))
    return [value for _, value in results]


def ma_rank(rank: int, rdv: str, out: str, tmp: str, st: dict) -> None:
    """One rank of the ``model=2`` group: (b)-(e), results pickled."""
    import pickle
    import traceback

    try:
        value = ma_rank_body(rank, rdv, tmp, st)
        payload = ("ok", value)
    except BaseException:  # noqa: BLE001 — reported to the parent
        payload = ("error", traceback.format_exc())
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(out, "wb") as f:
        pickle.dump(payload, f)


def ma_rank_body(rank: int, rdv: str, tmp: str, st: dict) -> dict:
    sys.path.insert(0, REPO)
    import hashlib

    import torch

    from deeplearning4j_tpu_torch import resolve_device
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.models import bert, gpt, lm_fit
    from deeplearning4j_tpu_torch.models import transformer as tfm
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.ops import updaters
    from deeplearning4j_tpu_torch.parallel import mesh as pm
    from deeplearning4j_tpu_torch.parallel import tensor_parallel as tpar
    from deeplearning4j_tpu_torch.serving.decode import DecodeEngine

    dev = st["device"]
    torch.set_num_threads(2)
    resolve_device(dev)
    pm.initialize_distributed(f"file://{rdv}", 2, rank, device=dev,
                              backend="gloo")
    mesh = pm.make_mesh(pm.MeshSpec(data=1, model=2), device=dev)
    shallow, deep, fp32, bcfg = ma_configs(gpt, bert, st)
    res = {"mesh": repr(mesh), "captures": pm.mesh_captures(mesh),
           "launches": {"launches": 0, "launches_dkv": 0, "launches_dq": 0}}

    def book(counts):
        for k, v in counts.items():
            res["launches"][k] += v

    # (b) fp32 at depth 2 against mesh=None's gathered params
    ids = ma_ids(shallow.vocab_size, st["steps"], st["B"], st["T"], 0)
    lm = lm_fit.CausalLM(shallow, lr=st["lr"], device=dev).init(0)
    log = MaLog()
    lm.listeners = [log]
    step, _ = lm._backprop_machinery(mesh)
    res["b_local_wq"] = tuple(step.shard_state(lm.params)["blocks"]["wq"]
                              .shape)
    fa.reset_launches()
    lm.fit_backprop([DataSet(x, x) for x in ids], num_epochs=1, mesh=mesh)
    ma_sync(torch, st)
    counts = fa.launch_counts()
    book(counts)
    res["b_launches"] = counts
    res["b_losses"] = log.seen
    res["b_rel"] = ma_rel(torch, lm.params_flat(),
                          torch.load(os.path.join(tmp, "b_flat.pt")))
    specs = step.param_specs
    repl = [t for grp in ("embed", "blocks") for name, t in
            sorted(lm.params[grp].items())
            if "model" not in tuple(specs[grp][name])]
    res["b_repl_sha"] = hashlib.sha256(b"".join(
        t.detach().float().cpu().numpy().tobytes() for t in repl)).hexdigest()
    del lm, step

    # (c) full depth, bf16
    one = ma_ids(deep.vocab_size, 1, st["B"], st["T"], 1)
    lm = lm_fit.CausalLM(deep, lr=st["lr"], mixed_precision="bf16",
                         device=dev).init(0)
    replicated_bytes = lm.num_param_bytes()
    init_flat = lm.params_flat()
    step, _ = lm._backprop_machinery(mesh)
    local = step.shard_state(lm.params)
    res["c_param_bytes"] = pm.per_device_bytes(local, mesh)
    res["c_replicated_bytes"] = replicated_bytes
    del local
    log = MaLog()
    lm.listeners = [log]
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    tpar.stats.reset()
    fa.reset_launches()
    ma_sync(torch, st)
    t0 = time.perf_counter()
    lm.fit_backprop([DataSet(x, x) for x in one], num_epochs=st["steps"],
                    mesh=mesh)
    ma_sync(torch, st)
    res["c_step_ms"] = (time.perf_counter() - t0) / st["steps"] * 1e3
    book(fa.launch_counts())
    res["c_launches"] = fa.launch_counts()
    ref_flat = torch.load(os.path.join(tmp, "c_flat.pt"))
    split = ma_flat(torch, tpar._spec_map(
        lambda leaf, spec: torch.full(
            (leaf.numel(),), spec is not None
            and tpar._model_dim(spec) is not None),
        lm.params, step.param_specs)).bool()
    res["c_split_share"] = float(split.float().mean())

    def delta_rel(flat):
        """(model-split leaves, replicated leaves): relative L2 of
        ``flat - ref_flat`` to mesh=None's change over the same leaves."""
        gap, moved = flat - ref_flat, ref_flat - init_flat
        return tuple(float(gap[m].norm() / moved[m].norm())
                     for m in (split, ~split))

    mesh_flat = lm.params_flat()
    res["c_delta_rel"] = delta_rel(mesh_flat)
    # control 1: every model-split leaf left at its init (a step that
    # skipped the sharded leaves' update)
    res["c_ctrl_frozen"] = delta_rel(
        torch.where(split, init_flat, mesh_flat))[0]
    del mesh_flat
    res["c_losses"] = log.seen
    res["c_stats"] = tpar.stats.snapshot()
    res["c_scale"] = float(lm.loss_scale["scale"])
    res["c_skips"] = lm.guard_skips
    res["c_peak_gb"] = (torch.cuda.max_memory_allocated() / 1e9
                        if dev == "cuda" else float("nan"))
    # one more step with the model axis's collectives timed
    lm.listeners = []
    tpar.stats.reset()
    fa.reset_launches()
    with tpar.timed():
        ma_sync(torch, st)
        t0 = time.perf_counter()
        lm.fit_backprop([DataSet(x, x) for x in one], num_epochs=1,
                        mesh=mesh)
        ma_sync(torch, st)
        res["c_timed_step_ms"] = (time.perf_counter() - t0) * 1e3
    book(fa.launch_counts())
    res["c_timed"] = tpar.stats.snapshot()
    # a fit ends by gathering the params (one all-gather a split leaf):
    # its share of the counts above, taken out of the per-step figures
    tpar.stats.reset()
    step.gather_state(step.shard_state(lm.params))
    res["c_gather"] = tpar.stats.snapshot()
    del lm, step
    # control 2: the 3 steps again from the init with copy_to_model's
    # backward returning this rank's partial gradient, not its sum over
    # model (a step that reduced wrongly); restored at once, its
    # launches booked nowhere
    lm = lm_fit.CausalLM(deep, lr=st["lr"], mixed_precision="bf16",
                         device=dev).init(0)
    sound = vars(tpar._CopyToModel)["backward"]
    tpar._CopyToModel.backward = staticmethod(lambda ctx, g: (g, None))
    try:
        lm.fit_backprop([DataSet(x, x) for x in one],
                        num_epochs=st["steps"], mesh=mesh)
    finally:
        tpar._CopyToModel.backward = sound
    res["c_ctrl_unsummed"] = delta_rel(lm.params_flat())
    del lm, ref_flat, init_flat, split

    # (d) the head-sharded decode engine
    params = gpt.init_params(torch.Generator(device=dev).manual_seed(1),
                             fp32, dev)
    eng = DecodeEngine(fp32, params, n_slots=st["prompts"],
                       buckets=(st["bucket"],), prefill_chunk=16, mesh=mesh,
                       device=dev)
    fa.reset_launches()
    t0 = time.perf_counter()
    res["d_tokens"] = ma_decode(eng, ma_prompts(fp32.vocab_size,
                                                st["prompts"]), st["tokens"])
    res["d_s"] = time.perf_counter() - t0
    book(fa.launch_counts())
    res["d_kv"] = eng.kv_bytes_per_slot
    res["d_slot_k"] = tuple(eng._state(eng._buckets[st["bucket"]])[0].k.shape)
    del eng, params

    # (e) BERT-base make_train_step on model=2
    params = bert.init_params(torch.Generator(device=dev).manual_seed(2),
                              bcfg, dev)
    batch = bert.synthetic_batch(5, bcfg, st["bert_B"], st["bert_T"],
                                 device=dev)
    opt = updaters.adamw(1e-4, weight_decay=0.01)
    _, bstep = bert.make_train_step(bcfg, mesh, optimizer=opt, device=dev)
    local = tfm.shard_tree(params, bstep.specs, mesh)
    del params
    attn = fa.make_attn_fn("auto", mesh=mesh)
    tp = tpar.model_group(mesh)
    loss, grads = tfm.value_and_grad(
        lambda p: bert.mlm_loss(bcfg, p, batch, None, attn, tp), local)
    grads = tfm.gather_tree(grads, bstep.specs, mesh)
    res["e_loss"] = float(loss)
    res["e_grad_rel"] = ma_rel(torch, ma_flat(torch, grads),
                               torch.load(os.path.join(tmp, "e_grads.pt")))
    del grads
    state = tfm.TrainState(local, opt.init(local), 0)
    losses = []
    fa.reset_launches()
    t0 = time.perf_counter()
    for _ in range(st["bert_steps"]):
        state, l_ = bstep(state, batch)
        losses.append(float(l_))
    res["e_step_ms"] = (time.perf_counter() - t0) / st["bert_steps"] * 1e3
    book(fa.launch_counts())
    res["e_launches"] = fa.launch_counts()
    res["e_losses"] = losses
    res["e_local_tok"] = tuple(state.params["embed"]["tok"].shape)
    return res


def model_axis_phase(torch, fa, card: str) -> dict:
    """Phase 19 (see the module docstring).  Returns the ranks' B1-B3
    launches on the main paths (b)-(e), summed over both ranks."""
    import shutil
    import tempfile

    from deeplearning4j_tpu_torch.models import bert, gpt
    from deeplearning4j_tpu_torch.runtime import compile_cache

    def say(msg):
        print(f"  {msg} [{card}]")

    compile_cache.clear()
    if MA_DEVICE == "cuda":
        gc_cuda(torch)
    check(not torch.distributed.is_initialized(),
          "phase 19 needs no process group up in this process")
    st = ma_settings()
    tmp = tempfile.mkdtemp(prefix="model-axis-")
    t = [time.perf_counter()]
    try:
        # the NCCL probe's processes start up while this process runs
        # the kernel cases and the references
        probe = (ma_start(ma_nccl_probe, tmp, "nccl")
                 if MA_DEVICE == "cuda" else None)
        worst = kernel_phase(torch, fa, MA_KERNEL_CASES)
        worst_bwd = kernel_bwd_phase(torch, fa, MA_KERNEL_CASES)
        t.append(time.perf_counter())
        ref = ma_references(torch, st, tmp)
        if MA_DEVICE == "cuda":
            gc_cuda(torch)
        t.append(time.perf_counter())
        if probe is not None:
            for r, msg in enumerate(ma_join(probe, "nccl")):
                say(f"(a) NCCL, two ranks on one card, rank {r}: "
                    + " ".join(msg.split())[:400])
        t.append(time.perf_counter())
        r0, r1 = ma_spawn(ma_rank, tmp, "model2", (tmp, st))
        t.append(time.perf_counter())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    shallow, deep, fp32, bcfg = ma_configs(gpt, bert, st)
    L = shallow.n_layers
    say(f"group: {r0['mesh']} and {r1['mesh']}; gloo over CUDA tensors "
        f"(NCCL refuses two ranks on one card); step capture "
        f"{'on' if r0['captures'] else 'off'}: gloo's collectives cannot "
        f"enter a CUDA graph (parallel.mesh.mesh_captures, keyed on the "
        f"group's backend); gloo took every collective on CUDA tensors "
        f"itself, no host staging (parallel/tensor_parallel.py)")
    check(not r0["captures"], "a gloo step must not be captured")

    # (b)
    want_b = {"launches": 2 * L * st["steps"],
              "launches_dkv": L * st["steps"],
              "launches_dq": L * st["steps"]}
    for r, res in enumerate((r0, r1)):
        say(f"(b) rank {r}: GPT-2 small depth {L} fp32, B={st['B']} "
            f"T={st['T']}, {st['steps']} steps: local wq "
            f"{res['b_local_wq']} ({res['b_local_wq'][2]} of "
            f"{shallow.n_heads} heads, B1-B3 at {st['B']} x "
            f"{res['b_local_wq'][2]} rows); gathered params against "
            f"mesh=None's: relative L2 {res['b_rel']:.3e} (<= "
            f"{MA_PARAMS_TOL:g}); losses {res['b_losses']} (mesh=None "
            f"{ref['b_losses']}); launches {res['b_launches']} (expected "
            f"{want_b})")
        check(res["b_rel"] <= MA_PARAMS_TOL,
              f"(b) rank {r}: params differ from mesh=None by "
              f"{res['b_rel']}")
        check(res["b_launches"] == want_b,
              f"(b) rank {r}: launches {res['b_launches']} != {want_b}")
        check(res["b_local_wq"][2] == shallow.n_heads // 2,
              f"(b) rank {r} holds {res['b_local_wq']}")
    check(r0["b_repl_sha"] == r1["b_repl_sha"],
          "(b) the replicated leaves differ between the ranks")
    say(f"(b) replicated leaves bit-equal across the ranks: sha256 "
        f"{r0['b_repl_sha'][:16]}")

    # (c): remat runs B1 twice a layer a step
    n = st["steps"]
    Ld = deep.n_layers
    want_c = {"launches": 2 * Ld * n, "launches_dkv": Ld * n,
              "launches_dq": Ld * n}
    for r, res in enumerate((r0, r1)):
        losses = np.array(res["c_losses"])
        rel = np.abs(losses - np.array(ref["c_losses"])) / np.abs(
            np.array(ref["c_losses"]))
        share = res["c_param_bytes"]
        mine = share[sorted(share)[r]]
        frac = mine / res["c_replicated_bytes"]
        dsplit, drepl = res["c_delta_rel"]
        usplit, urepl = res["c_ctrl_unsummed"]
        s, ts, g = res["c_stats"], res["c_timed"], res["c_gather"]
        calls = (s["calls"] - g["calls"]) / n
        mb = (s["bytes"] - g["bytes"]) / n / 1e6
        say(f"(c) rank {r}: GPT-2 small depth {deep.n_layers} bf16 mixed "
            f"precision, one batch x {n}: losses {losses.tolist()} "
            f"(mesh=None {ref['c_losses']}; largest relative difference "
            f"{rel.max():.3e} <= {MA_LOSS_TOL:g}); the params' change "
            f"against mesh=None's, relative L2 over the model-split leaves "
            f"({res['c_split_share']:.3f} of the params) "
            f"{dsplit:.3e}, over the replicated ones {drepl:.3e} (each <= "
            f"{MA_DELTA_TOL:g}); controls: the split leaves left at init "
            f"{res['c_ctrl_frozen']:.3e}, column-parallel input gradients "
            f"not summed over model {usplit:.3e} / {urepl:.3e} (each "
            f"control > {MA_DELTA_TOL:g} on the split leaves); step "
            f"{res['c_step_ms']:.1f} ms (host clock after synchronize, "
            f"eager, gloo-bound; mesh=None "
            f"{ref['c_step_ms']:.1f} ms, its capture included); model-axis "
            f"collectives {calls:g} a step, {mb:.1f} MB a step (the fit's "
            f"closing gather of the params {g['calls']} calls, "
            f"{g['bytes'] / 1e6:.1f} MB, aside); one more step under "
            f"tensor_parallel.timed() {res['c_timed_step_ms']:.1f} ms "
            f"(the device synchronized around each collective, which "
            f"slows it from the plain {res['c_step_ms']:.1f} ms) of which "
            f"gloo {ts['seconds'] * 1e3:.1f} ms, the gather included "
            f"({ts['seconds'] * 1e3 / res['c_timed_step_ms']:.1%} of the "
            f"timed step, inflated by its synchronizes); peak memory "
            f"{res['c_peak_gb']:.2f} GB; params {mine:,} bytes of "
            f"{res['c_replicated_bytes']:,} replicated ({frac:.3f} <= "
            f"{MA_SHARE_MAX}); guard skips {res['c_skips']}, loss scale "
            f"{res['c_scale']:g}; launches {res['c_launches']}")
        check(np.isfinite(losses).all(), f"(c) rank {r}: non-finite loss")
        check(losses[-1] < losses[0], f"(c) rank {r}: the loss did not "
                                      f"fall: {losses}")
        check(rel.max() <= MA_LOSS_TOL,
              f"(c) rank {r}: losses differ from mesh=None by {rel.max()}")
        check(max(dsplit, drepl) <= MA_DELTA_TOL,
              f"(c) rank {r}: the params' change differs from mesh=None's "
              f"by {dsplit} (split) / {drepl} (replicated)")
        check(min(res["c_ctrl_frozen"], usplit) > MA_DELTA_TOL,
              f"(c) rank {r}: a control reads {res['c_ctrl_frozen']} / "
              f"{usplit}, inside the limit {MA_DELTA_TOL}")
        check(res["c_launches"] == want_c,
              f"(c) rank {r}: launches {res['c_launches']} != {want_c}")
        check(frac <= MA_SHARE_MAX, f"(c) rank {r} holds {frac} of the "
                                    f"params")

    # (d)
    half = gpt.slots_bytes_per_slot(fp32, st["bucket"]) // 2
    for r, res in enumerate((r0, r1)):
        same = res["d_tokens"] == ref["d_tokens"]
        say(f"(d) rank {r}: DecodeEngine(mesh=) fp32, {st['prompts']} "
            f"prompts x {st['tokens']} greedy tokens in {res['d_s']:.1f} s: "
            f"equal to the replicated engine's: {same}; KV {res['d_kv']:,} "
            f"bytes a slot against {ref['d_kv']:,} replicated; slot cache "
            f"{res['d_slot_k']}")
        check(same, f"(d) rank {r}: tokens {res['d_tokens']} != "
                    f"{ref['d_tokens']}")
        check(res["d_kv"] == half == ref["d_kv"] // 2,
              f"(d) rank {r}: {res['d_kv']} KV bytes a slot")

    # (e): the launches of the bstep calls alone
    Lb, nb = bcfg.n_layers, st["bert_steps"]
    want_e = {"launches": 2 * Lb * nb, "launches_dkv": Lb * nb,
              "launches_dq": Lb * nb}
    for r, res in enumerate((r0, r1)):
        lrel = abs(res["e_loss"] - ref["e_loss"]) / abs(ref["e_loss"])
        srel = max(abs(a - b) / abs(b) for a, b in
                   zip(res["e_losses"], ref["e_losses"]))
        say(f"(e) rank {r}: BERT-base make_train_step(cfg, mesh) bf16, "
            f"B={st['bert_B']} T={st['bert_T']}: loss {res['e_loss']:.5f} "
            f"(mesh=None {ref['e_loss']:.5f}), gradients' relative L2 "
            f"{res['e_grad_rel']:.3e}, step losses {res['e_losses']} "
            f"(mesh=None {ref['e_losses']}); step {res['e_step_ms']:.1f} "
            f"ms; token table {res['e_local_tok']} (vocab over model); "
            f"launches {res['e_launches']} (expected {want_e})")
        check(res["e_launches"] == want_e,
              f"(e) rank {r}: launches {res['e_launches']} != {want_e}")
        check(max(lrel, srel, res["e_grad_rel"]) <= MA_BERT_TOL,
              f"(e) rank {r}: loss {lrel}, steps {srel}, gradients "
              f"{res['e_grad_rel']} > {MA_BERT_TOL}")

    launches = {k: r0["launches"][k] + r1["launches"][k]
                for k in r0["launches"]}
    names = ("B1-B3 at a rank's shapes", "mesh=None references",
             "the NCCL probe's rest (started with the kernel cases)",
             "two ranks (b)-(e)")
    say("phase 19 wall: " + ", ".join(
        f"{n_} {b - a:.1f} s" for n_, a, b in zip(names, t, t[1:]))
        + f"; total {t[-1] - t[0]:.1f} s; launches on the ranks' main paths "
          f"{launches}")
    return launches, worst, worst_bwd


# ---------------------------------------------------------------------------
# phase 20: the model axis for a serving fleet, and the expert axis
# ---------------------------------------------------------------------------

#: the device phase 20 runs on (a CPU rehearsal substitutes "cpu")
EA_DEVICE = "cuda"
#: (b) GPT-2 small in fp32 (gen_config's widths and depth): 8 concurrent
#: requests of 8-32 prompt tokens, 16 greedy tokens each, 8 slots of one
#: bucket of 64; the draft (distilgpt2's shape) proposes 4 a round
EA_REQS, EA_TOKENS, EA_BUCKET, EA_DRAFT_K = 8, 16, 64, 4
#: (c1) the MoE LM at depth 2 in fp32, capacity 8, SGD, through
#: moe.make_train_step; (d) its CausalLM at depth 2 in fp32 on model=2:
#: B x T, steps and learning rate of both
EA_SMALL_B, EA_SMALL_T, EA_SMALL_STEPS, EA_SMALL_LR = 4, 256, 2, 0.05
#: (c2) the MoE LM at full depth, bf16 mixed precision, capacity 1.25,
#: through CausalLM on data=1 x expert=2: one batch B x T, 3 steps
EA_B, EA_T, EA_STEPS, EA_LR = 8, 1024, 3, 0.05
#: (c1), (d): the gathered params against mesh=None's, relative L2
EA_PARAMS_TOL = 1e-5
#: (c2) a rank's share of the expert tables' bytes
EA_EXPERT_SHARE = (0.45, 0.55)
#: (a) the all-to-all's test tensors: the inbox of a rank at (c2)'s
#: shapes ([E, C, d] = 8 x 1280 x 768, bf16) and a small fp32 one
EA_A2A_SHAPES = (((8, 1280, 768), "bfloat16"), ((8, 6, 3), "float32"))


def ea_settings() -> dict:
    """What the rank processes need to know of this run (a spawned
    process does not see a rehearsal's changes to this module)."""
    return {"device": EA_DEVICE, "reqs": EA_REQS, "tokens": EA_TOKENS,
            "bucket": EA_BUCKET, "draft_k": EA_DRAFT_K,
            "small_B": EA_SMALL_B, "small_T": EA_SMALL_T,
            "small_steps": EA_SMALL_STEPS, "small_lr": EA_SMALL_LR,
            "B": EA_B, "T": EA_T, "steps": EA_STEPS, "lr": EA_LR,
            "a2a_shapes": EA_A2A_SHAPES, "gpt": None, "moe": None}


def ea_configs(gpt, moe, st):
    """(GPT-2 small fp32, its distilgpt2-shaped draft fp32, the MoE LM
    bf16 at full depth, the MoE LM fp32 at depth 2 and capacity 8)."""
    base = gen_config(gpt) if st["gpt"] is None else st["gpt"]
    fp32 = dataclasses.replace(base, compute_dtype="float32")
    draft = dataclasses.replace(fp32, n_layers=max(fp32.n_layers // 2, 1))
    mcfg = moe_config(moe) if st["moe"] is None else st["moe"]
    small = dataclasses.replace(mcfg, n_layers=2, compute_dtype="float32",
                                capacity_factor=8.0)
    return fp32, draft, mcfg, small


def ea_sync(torch, st) -> None:
    if st["device"] == "cuda":
        torch.cuda.synchronize()


def ea_prompts(vocab: int, n: int):
    rng = np.random.default_rng(20)
    return [rng.integers(0, vocab, int(rng.integers(8, 33)), dtype=np.int32)
            for _ in range(n)]


def ea_decode(eng, prompts, n: int, spec: bool = False):
    """Every prompt started in a slot of the engine's one bucket, then
    the bucket advanced (a plain step or a speculative round) until each
    has ``n`` greedy tokens."""
    placed = []
    for p in prompts:
        bucket, slot, first = eng.start(p, max_tokens=n, temperature=0.0,
                                        seed=0)
        placed.append((bucket, slot, [int(first)]))
    bucket = placed[0][0]
    while min(len(seen) for _, _, seen in placed) < n:
        if spec:
            out, n_c = eng.advance_spec(bucket)
            for _, slot, seen in placed:
                seen.extend(int(t) for t in out[slot, :int(n_c[slot])])
        else:
            toks = eng.advance(bucket)
            for _, slot, seen in placed:
                seen.append(int(toks[slot]))
    for b, slot, _ in placed:
        eng.release(b, slot)
    return [seen[:n] for _, _, seen in placed]


def ea_knobs(st, cfg_d, draft_params):
    """The engine knobs of (b) after the router's plain run: name ->
    DecodeEngine keyword arguments."""
    return {"int8 weights": {"quantize": "int8"},
            "int8 KV": {"kv_dtype": "int8"},
            "draft": {"draft": (cfg_d, draft_params),
                      "draft_k": st["draft_k"]}}


def ea_references(torch, st, tmp: str) -> dict:
    """The replicated and mesh=None runs, in this process on the card:
    written to ``tmp`` (or returned) for the ranks' results to be held
    against."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.models import gpt, lm_fit, moe
    from deeplearning4j_tpu_torch.models import transformer as tfm
    from deeplearning4j_tpu_torch.ops import updaters
    from deeplearning4j_tpu_torch.serving.decode import DecodeEngine

    dev = st["device"]
    fp32, cfg_d, mcfg, small = ea_configs(gpt, moe, st)
    out = {"tokens": {}}
    params = gpt.init_params(torch.Generator(device=dev).manual_seed(20),
                             fp32, dev)
    dparams = gpt.init_params(torch.Generator(device=dev).manual_seed(21),
                              cfg_d, dev)
    prompts = ea_prompts(fp32.vocab_size, st["reqs"])
    geo = dict(n_slots=st["reqs"], buckets=(st["bucket"],),
               prefill_chunk=16, device=dev)
    eng = DecodeEngine(fp32, params, **geo)
    out["tokens"]["plain"] = ea_decode(eng, prompts, st["tokens"])
    out["kv_plain"] = eng.kv_bytes_per_slot
    del eng
    for name, kw in ea_knobs(st, cfg_d, dparams).items():
        eng = DecodeEngine(fp32, params, **geo, **kw)
        out["tokens"][name] = ea_decode(eng, prompts, st["tokens"],
                                        spec="draft" in kw)
        out[f"kv_{name}"] = eng.kv_bytes_per_slot
        del eng
    del params, dparams
    # (c1): moe.make_train_step without a mesh, SGD
    gen = torch.Generator(device=dev).manual_seed(22)
    p0 = moe.init_params(gen, small, dev)
    ids = torch.as_tensor(ma_ids(small.vocab_size, 1, st["small_B"],
                                 st["small_T"], 22)[0]).to(dev)
    opt = updaters.sgd(st["small_lr"])
    _, step = moe.make_train_step(small, optimizer=opt, device=dev)
    state = tfm.TrainState(p0, opt.init(p0), 0)
    losses = []
    for _ in range(st["small_steps"]):
        state, loss = step(state, ids)
        losses.append(float(loss))
    out["c1_losses"] = losses
    torch.save(ma_flat(torch, state.params), os.path.join(tmp, "c1.pt"))
    del state, step, p0
    # (d): the MoE CausalLM at depth 2, capacity 1.25, without a mesh
    dcfg = dataclasses.replace(small, capacity_factor=1.25)
    lm = lm_fit.CausalLM(dcfg, lr=st["small_lr"], device=dev).init(23)
    batches = [DataSet(x, x) for x in ma_ids(
        dcfg.vocab_size, st["small_steps"], st["small_B"], st["small_T"],
        23)]
    lm.fit_backprop(batches, num_epochs=1)
    torch.save(lm.params_flat(), os.path.join(tmp, "d.pt"))
    del lm
    # (c3): the MoE LM at full depth, bf16, capacity 8, one step
    # without a mesh
    c8 = dataclasses.replace(mcfg, capacity_factor=8.0)
    lm = lm_fit.CausalLM(c8, lr=st["lr"], mixed_precision="bf16",
                         device=dev).init(24)
    log = MaLog()
    lm.listeners = [log]
    lm.fit_backprop([DataSet(x, x) for x in ma_ids(
        c8.vocab_size, 1, st["B"], st["T"], 24)], num_epochs=1)
    torch.save(lm.params_flat(), os.path.join(tmp, "c3.pt"))
    out["c3_skips"] = lm.guard_skips
    out["c3_losses"] = log.seen
    return out


def ea_rank(rank: int, rdv: str, out: str, tmp: str, st: dict) -> None:
    """One rank of the two: (a)-(d), results pickled."""
    import pickle
    import traceback

    try:
        value = ea_rank_body(rank, rdv, tmp, st)
        payload = ("ok", value)
    except BaseException:  # noqa: BLE001 — reported to the parent
        payload = ("error", traceback.format_exc())
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(out, "wb") as f:
        pickle.dump(payload, f)


def ea_serve(torch, batcher, prompts, n: int):
    """Every prompt submitted from a client thread of its own at once;
    each handle's greedy tokens."""
    results = [None] * len(prompts)

    def client(i):
        results[i] = batcher.submit(prompts[i], max_tokens=n,
                                    temperature=0.0).result(600).tolist()

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    return results


def ea_rank_body(rank: int, rdv: str, tmp: str, st: dict) -> dict:
    sys.path.insert(0, REPO)
    import torch
    import torch.distributed as dist

    from deeplearning4j_tpu_torch import resolve_device
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.models import gpt, lm_fit, moe
    from deeplearning4j_tpu_torch.models import transformer as tfm
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.ops import updaters
    from deeplearning4j_tpu_torch.parallel import collectives as col
    from deeplearning4j_tpu_torch.parallel import mesh as pm
    from deeplearning4j_tpu_torch.parallel import tensor_parallel as tpar
    from deeplearning4j_tpu_torch.runtime.quantize import tree_bytes
    from deeplearning4j_tpu_torch.serving.decode import (ContinuousBatcher,
                                                         DecodeEngine)
    from deeplearning4j_tpu_torch.serving.router import Router

    dev = st["device"]
    torch.set_num_threads(2)
    resolve_device(dev)
    pm.initialize_distributed(f"file://{rdv}", 2, rank, device=dev,
                              backend="gloo")
    fp32, cfg_d, mcfg, small = ea_configs(gpt, moe, st)
    res = {"launches": {"launches": 0, "launches_dkv": 0, "launches_dq": 0},
           "marks": [("start", time.perf_counter())]}

    def mark(name):
        """The host clock as part ``name`` ends.  The part's cached blocks
        are released (``torch.cuda.empty_cache``): each rank's caching
        allocator otherwise keeps its peak (37.7 GB a rank after (c3) on
        the H100), and the other rank sharing the card runs out of
        memory."""
        res["marks"].append((name, time.perf_counter()))
        if st["device"] == "cuda":
            gc_cuda(torch)

    def book(counts):
        for k, v in counts.items():
            res["launches"][k] += v

    # (a) the all-to-all on the device's tensors, forward and backward,
    # against a gather-and-slice
    emesh = pm.make_mesh(pm.MeshSpec(data=1, expert=2), device=dev)

    def a2a_calls():
        return col.stats.snapshot()["by_kind"]["all_to_all"]["calls"]

    a2a = []
    for shape, dt in st["a2a_shapes"]:
        gen = torch.Generator(device=dev).manual_seed(100 + rank)
        x = torch.randn(shape, generator=gen, device=dev).to(
            getattr(torch, dt)).requires_grad_(True)
        for split, concat in ((0, 1), (1, 0)):
            c0 = a2a_calls()
            y = col.all_to_all(x, (emesh, "expert"), split, concat)
            calls = a2a_calls() - c0
            parts = [torch.empty_like(x) for _ in range(2)]
            dist.all_gather(parts, x.detach())
            want = torch.cat([p.chunk(2, split)[rank] for p in parts], concat)
            w = torch.randn(y.shape, generator=gen, device=dev).to(y.dtype)
            (gx,) = torch.autograd.grad((y.float() * w.float()).sum(), x)
            ws = [torch.empty_like(w) for _ in range(2)]
            dist.all_gather(ws, w)
            gwant = torch.cat([ws[j].chunk(2, concat)[rank]
                               for j in range(2)], split)
            a2a.append({"shape": shape, "dtype": dt, "split": split,
                        "concat": concat, "fwd": bool(torch.equal(y, want)),
                        "bwd": bool(torch.equal(gx, gwant.to(gx.dtype))),
                        "calls": calls, "device": str(y.device)})
    res["a2a"] = a2a
    mark("(a)")

    # (b) GPT-2 small served over the model group
    params = gpt.init_params(torch.Generator(device=dev).manual_seed(20),
                             fp32, dev)
    prompts = ea_prompts(fp32.vocab_size, st["reqs"])
    geo = dict(n_slots=st["reqs"], buckets=(st["bucket"],),
               prefill_chunk=16)
    serve = {}
    fa.reset_launches()
    t0 = time.perf_counter()
    router = Router.replicate(fp32, params, n_replicas=2, model_degree=2,
                              device=dev, default_max_tokens=st["tokens"],
                              **geo)
    serve["router_build_s"] = time.perf_counter() - t0
    eng0 = router.batchers[0].engine
    serve["router_weight_bytes"] = tree_bytes(eng0.current_params())
    serve["router_kv"] = eng0.kv_bytes_per_slot
    if rank == 0:
        t0 = time.perf_counter()
        serve["router_tokens"] = ea_serve(torch, router, prompts,
                                          st["tokens"])
        serve["router_s"] = time.perf_counter() - t0
        serve["router_routed"] = list(router.routed)
    router.close()
    del router, eng0
    mmesh = pm.make_mesh(pm.MeshSpec(data=1, model=2), device=dev)
    dparams = gpt.init_params(torch.Generator(device=dev).manual_seed(21),
                              cfg_d, dev)
    for name, kw in ea_knobs(st, cfg_d, dparams).items():
        eng = DecodeEngine(fp32, params, mesh=mmesh, device=dev, **geo,
                           **kw)
        b = ContinuousBatcher(eng, default_max_tokens=st["tokens"])
        serve[f"{name}_weight_bytes"] = tree_bytes(eng.current_params())
        serve[f"{name}_kv"] = eng.kv_bytes_per_slot
        if b.leads:
            t0 = time.perf_counter()
            serve[f"{name}_tokens"] = ea_serve(torch, b, prompts,
                                               st["tokens"])
            serve[f"{name}_s"] = time.perf_counter() - t0
        b.close()
        del b, eng
    book(fa.launch_counts())
    serve["launches"] = fa.launch_counts()
    res["serve"] = serve
    res["replicated_weight_bytes"] = tree_bytes(gpt.serving_params(
        fp32, params))
    del params, dparams
    mark("(b)")

    # (c1) the MoE LM at depth 2, fp32, capacity 8, SGD: moe.make_train_step
    # on data=1 x expert=2 against mesh=None's params
    gen = torch.Generator(device=dev).manual_seed(22)
    p0 = moe.init_params(gen, small, dev)
    ids = torch.as_tensor(ma_ids(small.vocab_size, 1, st["small_B"],
                                 st["small_T"], 22)[0]).to(dev)
    opt = updaters.sgd(st["small_lr"])
    _, step = moe.make_train_step(small, emesh, optimizer=opt, device=dev)
    local = tpar.shard_tree(p0, step.specs, emesh)
    del p0
    state = tfm.TrainState(local, opt.init(local), 0)
    losses = []
    fa.reset_launches()
    for _ in range(st["small_steps"]):
        state, loss = step(state, ids)
        losses.append(float(loss))
    ea_sync(torch, st)
    book(fa.launch_counts())
    res["c1_launches"] = fa.launch_counts()
    res["c1_losses"] = losses
    res["c1_local_wi"] = tuple(state.params["blocks"]["wi"].shape)
    res["c1_rel"] = ma_rel(torch, ma_flat(torch, tpar.gather_tree(
        state.params, step.specs, emesh)), torch.load(
            os.path.join(tmp, "c1.pt")))
    del state, step, local
    mark("(c1)")

    # (c2) the MoE LM at full depth, bf16, capacity 1.25, through CausalLM
    lm = lm_fit.CausalLM(mcfg, lr=st["lr"], mixed_precision="bf16",
                         device=dev).init(24)
    full = {k: lm.params["blocks"][k].numel()
            * lm.params["blocks"][k].element_size() for k in ("wi", "wo_e")}
    step, _ = lm._backprop_machinery(emesh)
    local = step.shard_state(lm.params)
    res["c2_expert_bytes"] = (sum(
        local["blocks"][k].numel() * local["blocks"][k].element_size()
        for k in ("wi", "wo_e")), sum(full.values()))
    res["c2_local_wi"] = tuple(local["blocks"]["wi"].shape)
    del local
    log = MaLog()
    lm.listeners = [log]
    one = [DataSet(x, x) for x in ma_ids(mcfg.vocab_size, 1, st["B"],
                                         st["T"], 24)]
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    col.stats.reset()
    fa.reset_launches()
    ea_sync(torch, st)
    t0 = time.perf_counter()
    lm.fit_backprop(one, num_epochs=st["steps"], mesh=emesh)
    ea_sync(torch, st)
    fit_ms = (time.perf_counter() - t0) * 1e3
    counts = fa.launch_counts()
    book(counts)
    res["c2_launches"] = counts
    res["c2_losses"] = log.seen
    res["c2_stats"] = col.stats.snapshot()
    # a fit ends by gathering the expert tables (one all-gather a split
    # leaf): its time, taken out of the step's
    t0 = time.perf_counter()
    step.gather_state(step.shard_state(lm.params))
    ea_sync(torch, st)
    res["c2_gather_ms"] = (time.perf_counter() - t0) * 1e3
    res["c2_step_ms"] = (fit_ms - res["c2_gather_ms"]) / st["steps"]
    res["c2_skips"] = lm.guard_skips
    res["c2_peak_gb"] = (torch.cuda.max_memory_allocated() / 1e9
                         if dev == "cuda" else float("nan"))
    # one more step with every collective timed (the device synchronized
    # around each): the expert axis's all-to-alls, the gathers of the
    # tokens' outputs and cotangents, the routing statistics' and the
    # replicated leaves' gradients' all-reduces
    lm.listeners = []
    col.stats.reset()
    fa.reset_launches()
    with col.timed():
        ea_sync(torch, st)
        t0 = time.perf_counter()
        lm.fit_backprop(one, num_epochs=1, mesh=emesh)
        ea_sync(torch, st)
        res["c2_timed_ms"] = (time.perf_counter() - t0) * 1e3
    book(fa.launch_counts())
    res["c2_timed"] = col.stats.snapshot()
    # the closing gather's share, taken out of the per-step figures
    col.stats.reset()
    with col.timed():
        step.gather_state(step.shard_state(lm.params))
        ea_sync(torch, st)
    res["c2_gather"] = col.stats.snapshot()
    del lm, step
    mark("(c2)")

    # (c3) the same at capacity 8 (no token dropped on either layout),
    # one step: the change in the gathered params against mesh=None's
    # (on the card: the flat vectors hold ~0.54 G floats)
    c8 = dataclasses.replace(mcfg, capacity_factor=8.0)
    lm = lm_fit.CausalLM(c8, lr=st["lr"], mixed_precision="bf16",
                         device=dev).init(24)
    init_flat = lm.params_flat().to(dev)
    step, _ = lm._backprop_machinery(emesh)
    split = ma_flat(torch, tpar._spec_map(
        lambda leaf, spec: torch.full(
            (leaf.numel(),), spec is not None
            and bool(tpar._split_dims(spec))),
        lm.params, step.param_specs)).bool().to(dev)
    res["c3_split_share"] = float(split.float().mean())
    ref_flat = torch.load(os.path.join(tmp, "c3.pt")).to(dev)
    log = MaLog()
    lm.listeners = [log]
    fa.reset_launches()
    lm.fit_backprop(one, num_epochs=1, mesh=emesh)
    ea_sync(torch, st)
    counts = fa.launch_counts()
    book(counts)
    res["c3_launches"] = counts
    res["c3_losses"] = log.seen
    res["c3_skips"] = lm.guard_skips
    mesh_flat = lm.params_flat().to(dev)
    del lm, step

    def delta_rel(flat):
        """(expert-split leaves, replicated leaves): relative L2 of
        ``flat - ref_flat`` to mesh=None's change over the same leaves."""
        gap, moved = flat - ref_flat, ref_flat - init_flat
        return tuple(float(gap[m].norm() / moved[m].norm())
                     for m in (split, ~split))

    res["c3_delta_rel"] = delta_rel(mesh_flat)
    # controls: the expert tables left at init (a step that skipped
    # their update), and their change halved (their gradients averaged
    # over the expert group, which mixes two ranks' different experts,
    # or any factor-2 slip)
    res["c3_ctrl_frozen"] = delta_rel(
        torch.where(split, init_flat, mesh_flat))[0]
    res["c3_ctrl_half"] = delta_rel(torch.where(
        split, init_flat + 0.5 * (mesh_flat - init_flat), mesh_flat))[0]
    del mesh_flat, init_flat, ref_flat, split
    mark("(c3)")

    # (d) the MoE CausalLM at depth 2 on model=2 against mesh=None
    dcfg = dataclasses.replace(small, capacity_factor=1.25)
    lm = lm_fit.CausalLM(dcfg, lr=st["small_lr"], device=dev).init(23)
    step, _ = lm._backprop_machinery(mmesh)
    res["d_local"] = {k: tuple(step.shard_state(lm.params)["blocks"][k]
                               .shape) for k in ("wi", "wq")}
    batches = [DataSet(x, x) for x in ma_ids(
        dcfg.vocab_size, st["small_steps"], st["small_B"], st["small_T"],
        23)]
    fa.reset_launches()
    lm.fit_backprop(batches, num_epochs=1, mesh=mmesh)
    ea_sync(torch, st)
    book(fa.launch_counts())
    res["d_launches"] = fa.launch_counts()
    res["d_rel"] = ma_rel(torch, lm.params_flat(),
                          torch.load(os.path.join(tmp, "d.pt")))
    mark("(d)")
    return res


def expert_axis_phase(torch, fa, card: str) -> dict:
    """Phase 20 (see the module docstring).  Returns the ranks' B1-B3
    launches on the main paths (b)-(d), summed over both ranks."""
    import shutil
    import tempfile

    from deeplearning4j_tpu_torch.models import gpt, moe
    from deeplearning4j_tpu_torch.runtime import compile_cache

    def say(msg):
        print(f"  {msg} [{card}]")

    compile_cache.clear()
    if EA_DEVICE == "cuda":
        gc_cuda(torch)
    check(not torch.distributed.is_initialized(),
          "phase 20 needs no process group up in this process")
    st = ea_settings()
    tmp = tempfile.mkdtemp(prefix="expert-axis-")
    t = [time.perf_counter()]
    try:
        ref = ea_references(torch, st, tmp)
        # the references' captured graphs hold their memory pools until
        # their engine entries go: the two ranks need the card
        compile_cache.clear()
        if EA_DEVICE == "cuda":
            gc_cuda(torch)
        t.append(time.perf_counter())
        r0, r1 = ma_spawn(ea_rank, tmp, "expert2", (tmp, st), phase=20)
        t.append(time.perf_counter())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    fp32, cfg_d, mcfg, small = ea_configs(gpt, moe, st)

    # (a)
    for r, res in enumerate((r0, r1)):
        for c in res["a2a"]:
            say(f"(a) rank {r}: collectives.all_to_all on {c['device']} "
                f"{c['dtype']} {c['shape']}, split {c['split']} concat "
                f"{c['concat']}: forward bit-equal to gather-and-slice "
                f"{c['fwd']}, gradient bit-equal to the inverse exchange "
                f"{c['bwd']}, {c['calls']} all_to_all_single a call")
            check(c["fwd"] and c["bwd"] and c["calls"] == 1,
                  f"(a) rank {r}: all_to_all {c}")
        say(f"(a) rank {r}: gloo took the {st['device']} tensors for "
            f"all_to_all_single itself: the port stages nothing by hand")

    # (b)
    s0, s1 = r0["serve"], r1["serve"]
    rep_bytes = r0["replicated_weight_bytes"]
    runs = [("plain", "router")] + [(n, n) for n in
                                    ("int8 weights", "int8 KV", "draft")]
    for name, key in runs:
        got = s0[f"{key}_tokens"]
        want = ref["tokens"][name]
        same = got == want
        say(f"(b) GPT-2 small fp32 {name}"
            + (f" through Router.replicate(model_degree=2, n_replicas=2) "
               f"(built in {s0['router_build_s']:.1f} s, routed "
               f"{s0['router_routed']})" if key == "router" else
               " through DecodeEngine(mesh=) + ContinuousBatcher")
            + f": {st['reqs']} concurrent requests x {st['tokens']} greedy "
              f"tokens in {s0[f'{key}_s']:.1f} s, equal to the replicated "
              f"one-process engine's: {same}; KV "
              f"{s0[f'{key}_kv']:,} bytes a slot a rank (replicated "
              f"{ref['kv_' + name]:,}); weights "
              f"{s0[f'{key}_weight_bytes']:,} bytes a rank ("
              f"{s0[f'{key}_weight_bytes'] / rep_bytes:.3f} of the "
              f"replicated fp32 engine's {rep_bytes:,})")
        check(same, f"(b) {name}: tokens {got} != {want}")
        check(s0[f"{key}_kv"] == s1[f"{key}_kv"],
              f"(b) {name}: the ranks' KV bytes differ")
    say(f"(b) rank 1 followed every schedule; B1-B3 launches while "
        f"serving (rank 0) {s0['launches']}: decode attends through "
        f"gpt._cache_attention, no B1")

    # (c1)
    L = small.n_layers
    n = st["small_steps"]
    want_c1 = {"launches": 2 * L * n, "launches_dkv": L * n,
               "launches_dq": L * n}
    for r, res in enumerate((r0, r1)):
        say(f"(c1) rank {r}: the MoE LM at GPT-2 small's widths, depth {L}, "
            f"fp32, capacity {small.capacity_factor:g}, "
            f"moe.make_train_step on data=1 x expert=2, B="
            f"{st['small_B']} T={st['small_T']}, {n} SGD steps: losses "
            f"{res['c1_losses']} (mesh=None {ref['c1_losses']}); the "
            f"gathered params against mesh=None's: relative L2 "
            f"{res['c1_rel']:.3e} (<= {EA_PARAMS_TOL:g}); local wi "
            f"{res['c1_local_wi']}; launches {res['c1_launches']} "
            f"(expected {want_c1})")
        check(res["c1_rel"] <= EA_PARAMS_TOL,
              f"(c1) rank {r}: params differ by {res['c1_rel']}")
        check(res["c1_launches"] == want_c1,
              f"(c1) rank {r}: launches {res['c1_launches']}")

    # (c2)
    Lf, n = mcfg.n_layers, st["steps"]
    want_c2 = {"launches": 2 * Lf * n, "launches_dkv": Lf * n,
               "launches_dq": Lf * n}
    for r, res in enumerate((r0, r1)):
        losses = np.array(res["c2_losses"])
        mine, whole = res["c2_expert_bytes"]
        s2, ts, g = res["c2_stats"], res["c2_timed"], res["c2_gather"]

        def per_step(kind=None):
            """(calls, MB) a plain step, the closing gather taken out."""
            a = s2 if kind is None else s2["by_kind"][kind]
            b = g if kind is None else g["by_kind"][kind]
            return ((a["calls"] - b["calls"]) / n,
                    (a["bytes"] - b["bytes"]) / n / 1e6)

        def timed_ms(kind=None):
            a = ts if kind is None else ts["by_kind"][kind]
            b = g if kind is None else g["by_kind"][kind]
            return (a["seconds"] - b["seconds"]) * 1e3

        step_ms = res["c2_timed_ms"] - g["seconds"] * 1e3
        one = s2["one_rank"]
        kinds = "; ".join(
            f"{k} {per_step(k)[0]:g} calls, {per_step(k)[1]:.1f} MB, "
            f"{timed_ms(k):.1f} ms ({timed_ms(k) / step_ms:.1%})"
            for k in ("all_to_all", "all_reduce", "all_gather"))
        say(f"(c2) rank {r}: the MoE LM at GPT-2 small's widths and depth "
            f"({Lf} layers, {mcfg.n_experts} experts of {mcfg.d_ff}), bf16 "
            f"mixed precision, capacity {mcfg.capacity_factor:g}, CausalLM "
            f"on data=1 x expert=2, one batch B={st['B']} T={st['T']} x "
            f"{n}: losses {losses.tolist()}; step {res['c2_step_ms']:.1f} "
            f"ms a rank (host clock after synchronize, eager over gloo; "
            f"the fit's closing gather, {res['c2_gather_ms']:.1f} ms, "
            f"taken out); "
            f"one more step under collectives.timed() {step_ms:.1f} ms "
            f"(the device synchronized around each collective; the fit's "
            f"closing gather of the expert tables, {g['calls']} calls, "
            f"{g['bytes'] / 1e6:.1f} MB, {g['seconds'] * 1e3:.1f} ms, taken "
            f"out), of which gloo {timed_ms():.1f} ms "
            f"({timed_ms() / step_ms:.1%}): {per_step()[0]:g} collectives, "
            f"{per_step()[1]:.1f} MB sent a step a rank; by kind: {kinds}; "
            f"on a group of one rank (the data axis of data=1: the "
            f"gradients' sum) {one['calls'] / n:g} calls, "
            f"{one['bytes'] / n / 1e6:.1f} MB a step, "
            f"{ts['one_rank']['seconds'] * 1e3:.1f} ms of the timed step; "
            f"expert tables {mine:,} of {whole:,} bytes "
            f"({mine / whole:.3f}); local wi {res['c2_local_wi']}; peak "
            f"memory {res['c2_peak_gb']:.2f} GB; guard skips "
            f"{res['c2_skips']}; launches {res['c2_launches']} (expected "
            f"{want_c2})")
        check(np.isfinite(losses).all(), f"(c2) rank {r}: non-finite loss")
        check(losses[-1] < losses[0], f"(c2) rank {r}: the loss did not "
                                      f"fall: {losses}")
        check(res["c2_launches"] == want_c2,
              f"(c2) rank {r}: launches {res['c2_launches']} != {want_c2}")
        check(EA_EXPERT_SHARE[0] <= mine / whole <= EA_EXPERT_SHARE[1],
              f"(c2) rank {r} holds {mine / whole} of the expert tables")
    check(r0["c2_losses"] == r1["c2_losses"],
          "(c2) the ranks' losses differ")

    # (c3)
    want_c3 = {"launches": 2 * Lf, "launches_dkv": Lf, "launches_dq": Lf}
    for r, res in enumerate((r0, r1)):
        dsplit, drepl = res["c3_delta_rel"]
        say(f"(c3) rank {r}: (c2) at capacity 8 (no token dropped on "
            f"either layout), one step: loss {res['c3_losses']} (mesh=None "
            f"{ref['c3_losses']}); the gathered params' change against "
            f"mesh=None's, relative L2 over the expert-split leaves "
            f"({res['c3_split_share']:.3f} of the params) {dsplit:.3e}, "
            f"over the replicated ones {drepl:.3e} (each <= "
            f"{MA_DELTA_TOL:g}); controls: the expert tables left at init "
            f"{res['c3_ctrl_frozen']:.3e}, their change halved "
            f"{res['c3_ctrl_half']:.3e} (each > {MA_DELTA_TOL:g}); guard "
            f"skips {res['c3_skips']} (mesh=None {ref['c3_skips']}); "
            f"launches {res['c3_launches']} (expected {want_c3})")
        check(dsplit <= MA_DELTA_TOL and drepl <= MA_DELTA_TOL,
              f"(c3) rank {r}: the change differs from mesh=None's by "
              f"{dsplit} / {drepl}")
        for name in ("frozen", "half"):
            check(res[f"c3_ctrl_{name}"] > MA_DELTA_TOL,
                  f"(c3) rank {r}: the {name} control reads "
                  f"{res[f'c3_ctrl_{name}']}, inside the limit")
        check(res["c3_skips"] == ref["c3_skips"],
              f"(c3) rank {r}: guard skips {res['c3_skips']} != mesh=None's "
              f"{ref['c3_skips']}")
        check(res["c3_launches"] == want_c3,
              f"(c3) rank {r}: launches {res['c3_launches']} != {want_c3}")

    # (d)
    want_d = {"launches": 2 * L * st["small_steps"],
              "launches_dkv": L * st["small_steps"],
              "launches_dq": L * st["small_steps"]}
    for r, res in enumerate((r0, r1)):
        say(f"(d) rank {r}: the MoE CausalLM at depth {L}, fp32, capacity "
            f"1.25 on data=1 x model=2 (local wi {res['d_local']['wi']}, "
            f"wq {res['d_local']['wq']}), {st['small_steps']} batches: the "
            f"params against mesh=None's, relative L2 {res['d_rel']:.3e} "
            f"(<= {EA_PARAMS_TOL:g}); launches {res['d_launches']}")
        check(res["d_rel"] <= EA_PARAMS_TOL,
              f"(d) rank {r}: params differ by {res['d_rel']}")
        check(res["d_launches"] == want_d,
              f"(d) rank {r}: launches {res['d_launches']} != {want_d}")

    launches = {k: r0["launches"][k] + r1["launches"][k]
                for k in r0["launches"]}
    names = ("replicated and mesh=None references", "two ranks (a)-(d)")
    parts = r0["marks"]
    say("phase 20 wall: " + ", ".join(
        f"{n_} {b - a:.1f} s" for n_, a, b in zip(names, t, t[1:]))
        + " (rank 0: " + ", ".join(
            f"{n_} {b - a:.1f} s" for (_, a), (n_, b) in zip(parts,
                                                            parts[1:]))
        + f"); launches on the ranks' main paths {launches}")
    return launches


# ---------------------------------------------------------------------------
# phase 21: the pipe and seq axes
# ---------------------------------------------------------------------------

#: the device phase 21 runs on (a CPU rehearsal substitutes "cpu")
PS_DEVICE = "cuda"
#: (b)/(c) GPT-2 small (dropout 0): B=8 T=1024, SGD lr 0.05 momentum
#: 0.9, 4 pipeline microbatches; depth 2 in fp32 over 3 seeded batches,
#: depth 6 in bf16 mixed precision over one batch 3 times (12 until the
#: script's clock needed room: the losses' 2e-2 holds at any depth, and
#: a seq=2 step took 4.9 s at 12)
PS_B, PS_T, PS_STEPS, PS_LR, PS_MOM, PS_MICRO, PS_DEPTH_FP32 = \
    8, 1024, 3, 0.05, 0.9, 4, 2
PS_DEPTH_BF16 = 6
#: BERT-base MLM, bf16, dropout 0: B=32 T=128, 3 steps, 4 microbatches
PS_BERT_B, PS_BERT_T, PS_BERT_STEPS, PS_BERT_MICRO = 32, 128, 3, 4
#: (a) ring attention at GPT-2 small's attention: B, T, heads, D
PS_RING = (8, 1024, 12, 64)
#: tolerances: the depth-2 params (relative L2 over the tree); every
#: step's loss (relative)
PS_PARAMS_TOL, PS_LOSS_TOL = 1e-5, 2e-2
#: a rank's share of the stacked blocks' bytes on pipe=2
PS_BLOCK_SHARE = (0.45, 0.55)


def ps_settings() -> dict:
    return {"device": PS_DEVICE, "B": PS_B, "T": PS_T, "steps": PS_STEPS,
            "lr": PS_LR, "mom": PS_MOM, "micro": PS_MICRO,
            "depth": PS_DEPTH_FP32, "depth_bf16": PS_DEPTH_BF16,
            "bert_B": PS_BERT_B,
            "bert_T": PS_BERT_T, "bert_steps": PS_BERT_STEPS,
            "bert_micro": PS_BERT_MICRO, "ring": PS_RING, "gpt": None,
            "bert": None}


def ps_configs(gpt, bert, st):
    """(GPT fp32 at (b)'s depth, GPT bf16 at PS_DEPTH_BF16 (the base's
    depth when it is shallower), BERT-base bf16), all without dropout."""
    base = gpt.gpt_config() if st["gpt"] is None else st["gpt"]
    base = dataclasses.replace(base, dropout=0.0)
    shallow = dataclasses.replace(base, compute_dtype="float32",
                                  n_layers=st["depth"])
    bcfg = bert.bert_base() if st["bert"] is None else st["bert"]
    return (shallow, dataclasses.replace(
        base, compute_dtype="bfloat16",
        n_layers=min(base.n_layers, st["depth_bf16"])),
        dataclasses.replace(bcfg, dropout=0.0))


def ps_lm(lm_fit, cfg, st, **kw):
    return lm_fit.CausalLM(cfg, lr=st["lr"], momentum=st["mom"],
                           pipe_microbatches=st["micro"],
                           device=st["device"], **kw).init(0)


def ps_gap(torch, got: dict, ref: dict) -> float:
    """The relative L2 gap of two param trees (flat dicts of leaves), over
    the whole tree: a leaf whose gradient is zero in exact arithmetic
    (the key bias) stays near zero, and a gap read leaf by leaf would be
    its rounding's over nothing."""
    g = torch.cat([got[k].reshape(-1) for k in sorted(ref)])
    r = torch.cat([ref[k].reshape(-1) for k in sorted(ref)])
    return float((g - r).norm() / r.norm().clamp_min(1e-30))


def ps_leaves(lm_fit, tree) -> dict:
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{path}/{k}")
        else:
            out[path] = t.detach().float().cpu()
    walk(tree, "")
    return out


def ps_bert_batch(bert, bcfg, st):
    return bert.synthetic_batch(7, bcfg, st["bert_B"], st["bert_T"],
                                device=st["device"])


def ps_bert_params(torch, bert, bcfg, st):
    return bert.init_params(torch.Generator(device=st["device"])
                            .manual_seed(2), bcfg, st["device"])


def ps_references(torch, st, tmp: str) -> dict:
    """The mesh=None runs, in this process on the card."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.models import bert, gpt, lm_fit
    from deeplearning4j_tpu_torch.ops import updaters

    shallow, deep, bcfg = ps_configs(gpt, bert, st)
    out = {}
    lm = ps_lm(lm_fit, shallow, st)
    ids = ma_ids(shallow.vocab_size, st["steps"], st["B"], st["T"], 0)
    lm.fit_backprop([DataSet(x, x) for x in ids], num_epochs=1)
    torch.save(ps_leaves(lm_fit, lm.params), os.path.join(tmp, "b.pt"))
    del lm
    lm = ps_lm(lm_fit, deep, st, mixed_precision="bf16")
    log = MaLog()
    lm.listeners = [log]
    one = ma_ids(deep.vocab_size, 1, st["B"], st["T"], 1)
    ma_sync(torch, st)
    t0 = time.perf_counter()
    lm.fit_backprop([DataSet(x, x) for x in one], num_epochs=st["steps"])
    ma_sync(torch, st)
    out["deep_step_ms"] = (time.perf_counter() - t0) / st["steps"] * 1e3
    out["deep_losses"] = log.seen
    del lm
    params = ps_bert_params(torch, bert, bcfg, st)
    opt = updaters.adamw(1e-4, weight_decay=0.01)
    _, step = bert.make_train_step(bcfg, optimizer=opt, device=st["device"])
    state = bert.TrainState(params, opt.init(params), 0)
    batch = ps_bert_batch(bert, bcfg, st)
    losses = []
    for _ in range(st["bert_steps"]):
        state, l_ = step(state, batch)
        losses.append(float(l_))
    out["bert_losses"] = losses
    return out


def ps_rank(rank: int, rdv: str, out: str, tmp: str, st: dict) -> None:
    """One rank of the two: (a)-(c), results pickled."""
    import pickle
    import traceback

    try:
        value = ps_rank_body(rank, rdv, tmp, st)
        payload = ("ok", value)
    except BaseException:  # noqa: BLE001 — reported to the parent
        payload = ("error", traceback.format_exc())
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(out, "wb") as f:
        pickle.dump(payload, f)


def ps_ring_checks(torch, fa, tfm, ra, col, mesh, st) -> list:
    """(a): ring attention over B1-B3 against the ring over plain
    blocks, with each kernel's launches, and Ulysses against the plain
    full attention, at this rank's block of GPT-2 small's attention."""
    B, T, H, D = st["ring"]
    n, r = 2, mesh.seq_rank
    tl = T // n
    dev = st["device"]
    gen = torch.Generator(device=dev).manual_seed(21)
    full = [torch.randn((B, T, H, D), generator=gen, device=dev)
            .to(torch.bfloat16) for _ in range(4)]
    q, k, v, do = (t[:, r * tl:(r + 1) * tl].contiguous() for t in full)
    axis = (mesh, "seq")
    rows = []
    for causal in (True, False):
        res = {"causal": causal}
        outs = {}
        for block in ("flash", "plain"):
            ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
            fa.reset_launches()
            o = ra.ring_attention(*ts, None, causal, axis, block=block)
            grads = torch.autograd.grad(o, ts, do)
            ma_sync(torch, st)
            outs[block] = (o.detach(), grads)
            if block == "flash":
                res["launches"] = fa.launch_counts()
        o_f, g_f = outs["flash"]
        o_p, g_p = outs["plain"]
        tol = TOL["bfloat16"]
        res["o_err"] = float((o_f.float() - o_p.float()).abs().max())
        res["o_ok"] = bool(torch.allclose(o_f.float(), o_p.float(),
                                          rtol=tol, atol=tol))
        res["grads"] = [bwd_error(torch, a, b, "bfloat16")
                        for a, b in zip(g_f, g_p)]
        res["blocks"] = r + 1 if causal else n
        # Ulysses (B1-B3 through FlashAttentionFn) against the plain full
        # attention, this rank's block
        ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o_u = ra.ulysses_attention(*ts, None, causal, axis).detach()
        ref = tfm.attention(*(t.float() for t in full[:3]), None, causal)
        ref = ref[:, r * tl:(r + 1) * tl]
        res["u_err"] = float((o_u.float() - ref).abs().max())
        res["u_ok"] = bool(torch.allclose(o_u.float(), ref, rtol=tol,
                                          atol=tol))
        rows.append(res)
    return rows


def ps_fit(torch, fa, lm_fit, lm, ids, st, mesh, epochs, col=None):
    """One fit on ``mesh``: (losses, step ms, launches, stats)."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    log = MaLog()
    lm.listeners = [log]
    fa.reset_launches()
    if col is not None:
        col.stats.reset()
    ma_sync(torch, st)
    t0 = time.perf_counter()
    lm.fit_backprop([DataSet(x, x) for x in ids], num_epochs=epochs,
                    mesh=mesh)
    ma_sync(torch, st)
    ms = (time.perf_counter() - t0) / (epochs * len(ids)) * 1e3
    stats = col.stats.snapshot() if col is not None else None
    return log.seen, ms, fa.launch_counts(), stats


def ps_axis(torch, fa, res, key, mesh, st, tmp) -> None:
    """(b) or (c) on ``mesh`` (``key``: "pipe" or "seq"), into ``res``."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.models import bert, gpt, lm_fit
    from deeplearning4j_tpu_torch.models import transformer as tfm
    from deeplearning4j_tpu_torch.ops import updaters
    from deeplearning4j_tpu_torch.parallel import collectives as col

    shallow, deep, bcfg = ps_configs(gpt, bert, st)
    out = res[key] = {"launches": {"launches": 0, "launches_dkv": 0,
                                   "launches_dq": 0}}

    def book(counts):
        for k_, v_ in counts.items():
            out["launches"][k_] += v_

    # depth 2, fp32: the params, for the parent to hold against
    # mesh=None's (its reference runs while the ranks start)
    rank = torch.distributed.get_rank()
    ids = ma_ids(shallow.vocab_size, st["steps"], st["B"], st["T"], 0)
    lm = ps_lm(lm_fit, shallow, st)
    losses, _, counts, _ = ps_fit(torch, fa, lm_fit, lm, ids, st, mesh, 1)
    book(counts)
    torch.save(ps_leaves(lm_fit, lm.params),
               os.path.join(tmp, f"{key}-shallow-{rank}.pt"))
    out["shallow_launches"] = counts
    del lm
    if key == "pipe":
        # the control: the tied embedding's halves not summed over pipe
        lm = ps_lm(lm_fit, shallow, st)
        sound = lm_fit._sum_over_pipe
        lm_fit._sum_over_pipe = lambda grads, m: grads
        try:
            ps_fit(torch, fa, lm_fit, lm, ids, st, mesh, 1)
        finally:
            lm_fit._sum_over_pipe = sound
        torch.save(ps_leaves(lm_fit, lm.params),
                   os.path.join(tmp, f"{key}-control-{rank}.pt"))
        del lm

    # depth PS_DEPTH_BF16, bf16
    one = ma_ids(deep.vocab_size, 1, st["B"], st["T"], 1)
    lm = ps_lm(lm_fit, deep, st, mixed_precision="bf16")
    step, _ = lm._backprop_machinery(mesh)
    local = step.shard_state(lm.params)
    out["blocks_bytes"] = sum(t.numel() * t.element_size()
                              for t in local["blocks"].values())
    out["all_blocks_bytes"] = sum(t.numel() * t.element_size()
                                  for t in lm.params["blocks"].values())
    out["rank_bytes"] = sum(t.numel() * t.element_size() for t in
                            updaters.tree_leaves(local))
    out["replicated_bytes"] = lm.num_param_bytes()
    del local
    if st["device"] == "cuda":
        torch.cuda.reset_peak_memory_stats()
    losses, ms, counts, stats = ps_fit(torch, fa, lm_fit, lm, one, st, mesh,
                                       st["steps"], col)
    book(counts)
    out.update(deep_losses=losses, deep_step_ms=ms, deep_launches=counts,
               deep_stats=stats, deep_scale=float(lm.loss_scale["scale"]),
               deep_skips=lm.guard_skips,
               peak_gb=(torch.cuda.max_memory_allocated() / 1e9
                        if st["device"] == "cuda" else float("nan")))
    lm.listeners = []
    col.stats.reset()
    fa.reset_launches()
    with col.timed():
        ma_sync(torch, st)
        t0 = time.perf_counter()
        lm.fit_backprop([DataSet(x, x) for x in one], num_epochs=1,
                        mesh=mesh)
        ma_sync(torch, st)
        out["timed_ms"] = (time.perf_counter() - t0) * 1e3
    book(fa.launch_counts())
    out["timed"] = col.stats.snapshot()
    del lm, step

    # BERT-base: the pipeline step, or the sequence-parallel one
    params = ps_bert_params(torch, bert, bcfg, st)
    batch = ps_bert_batch(bert, bcfg, st)
    opt = updaters.adamw(1e-4, weight_decay=0.01)
    if key == "pipe":
        _, bstep = bert.make_pipeline_train_step(bcfg, mesh,
                                                 st["bert_micro"], opt,
                                                 device=st["device"])
        params = tfm.shard_tree(params, bstep.specs, mesh)
    else:
        _, bstep = bert.make_sp_train_step(bcfg, mesh, opt,
                                           device=st["device"])
    state = bert.TrainState(params, opt.init(params), 0)
    losses = []
    fa.reset_launches()
    ma_sync(torch, st)
    t0 = time.perf_counter()
    for _ in range(st["bert_steps"]):
        state, l_ = bstep(state, batch)
        losses.append(float(l_))
    ma_sync(torch, st)
    out["bert_step_ms"] = (time.perf_counter() - t0) / st["bert_steps"] * 1e3
    out["bert_losses"] = losses
    out["bert_launches"] = fa.launch_counts()
    book(out["bert_launches"])


def ps_rank_body(rank: int, rdv: str, tmp: str, st: dict) -> dict:
    sys.path.insert(0, REPO)
    import torch

    from deeplearning4j_tpu_torch import resolve_device
    from deeplearning4j_tpu_torch.models import transformer as tfm
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.parallel import collectives as col
    from deeplearning4j_tpu_torch.parallel import mesh as pm
    from deeplearning4j_tpu_torch.parallel import ring_attention as ra

    dev = st["device"]
    torch.set_num_threads(2)
    resolve_device(dev)
    pm.initialize_distributed(f"file://{rdv}", 2, rank, device=dev,
                              backend="gloo")
    pipe = pm.make_mesh(pm.MeshSpec(data=1, pipe=2), device=dev)
    seq = pm.make_mesh(pm.MeshSpec(data=1, seq=2), device=dev)
    res = {"pipe_mesh": repr(pipe), "seq_mesh": repr(seq)}

    # (a) the ring shift on the card's tensors
    x = (torch.arange(6, dtype=torch.float32, device=dev).reshape(2, 3)
         + 100 * rank).requires_grad_(True)
    col.stats.reset()
    y = col.ring_permute(x, (pipe, "pipe"))
    fwd = dict(col.stats.snapshot()["by_kind"]["ring_permute"])
    (g,) = torch.autograd.grad((y * (rank + 2)).sum(), [x])
    other = torch.arange(6, dtype=torch.float32, device=dev).reshape(2, 3) \
        + 100 * (1 - rank)
    res["shift"] = {"device": str(y.device),
                    "value": bool(torch.equal(y.detach(), other)),
                    "grad": bool(torch.equal(g, torch.full_like(
                        g, float(1 - rank + 2)))),
                    "calls": fwd["calls"], "bytes": fwd["bytes"],
                    "nbytes": x.numel() * x.element_size()}
    # each part's cached blocks are released before the next: the other
    # rank and the references share the card
    res["ring"] = ps_ring_checks(torch, fa, tfm, ra, col, seq, st)
    if dev == "cuda":
        gc_cuda(torch)
    ps_axis(torch, fa, res, "pipe", pipe, st, tmp)
    if dev == "cuda":
        gc_cuda(torch)
    ps_axis(torch, fa, res, "seq", seq, st, tmp)
    return res


def ps_share(stats) -> str:
    """gloo's ms and share of the timed step by kind."""
    return ", ".join(f"{k} {v['calls']} calls {v['bytes'] / 1e6:.1f} MB "
                     f"{v['seconds'] * 1e3:.1f} ms"
                     for k, v in stats["by_kind"].items() if v["calls"])


def pipe_seq_phase(torch, fa, card: str) -> dict:
    """Phase 21 (see the module docstring).  Returns the ranks' B1-B3
    launches on the main paths (b) and (c), summed over both ranks."""
    import shutil
    import tempfile

    from deeplearning4j_tpu_torch.models import bert, gpt
    from deeplearning4j_tpu_torch.runtime import compile_cache

    def say(msg):
        print(f"  {msg} [{card}]")

    compile_cache.clear()
    if PS_DEVICE == "cuda":
        gc_cuda(torch)
    check(not torch.distributed.is_initialized(),
          "phase 21 needs no process group up in this process")
    st = ps_settings()
    tmp = tempfile.mkdtemp(prefix="pipe-seq-")
    t = [time.perf_counter()]
    try:
        # the ranks start up and run (a) while this process runs the
        # references; they write their depth-2 params for it to compare
        started = ma_start(ps_rank, tmp, "pipeseq", (tmp, st))
        ref = ps_references(torch, st, tmp)
        # the references' captured graphs hold their memory pools until
        # their engine entries go: the two ranks share the card
        compile_cache.clear()
        if PS_DEVICE == "cuda":
            gc_cuda(torch)
        t.append(time.perf_counter())
        ranks = ma_join(started, "pipeseq", phase=21)
        t.append(time.perf_counter())
        b_ref = torch.load(os.path.join(tmp, "b.pt"))
        for r, res in enumerate(ranks):
            for key in ("pipe", "seq"):
                got = torch.load(os.path.join(tmp, f"{key}-shallow-{r}.pt"))
                res[key]["shallow_gap"] = ps_gap(torch, got, b_ref)
                res[key]["shallow_equal"] = all(
                    torch.equal(got[k_], b_ref[k_]) for k_ in b_ref)
            res["pipe"]["control_gap"] = ps_gap(torch, torch.load(
                os.path.join(tmp, f"pipe-control-{r}.pt")), b_ref)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    shallow, deep, bcfg = ps_configs(gpt, bert, st)
    say(f"groups: {ranks[0]['pipe_mesh']}, {ranks[0]['seq_mesh']} and rank "
        f"1's; gloo over CUDA tensors, eager")

    # (a)
    for r, res in enumerate(ranks):
        s = res["shift"]
        say(f"(a) rank {r}: ring_permute on {s['device']}: the neighbour's "
            f"block bit-equal {s['value']}, its gradient the inverse shift "
            f"{s['grad']}, {s['calls']} call of {s['bytes']} bytes (the "
            f"tensor: {s['nbytes']})")
        check(s["value"] and s["grad"] and s["calls"] == 1
              and s["bytes"] == s["nbytes"], f"(a) rank {r}: {s}")
        for row in res["ring"]:
            n_b = row["blocks"]
            want = {"launches": n_b, "launches_dkv": n_b, "launches_dq": n_b}
            errs = ", ".join(f"{e:.3e}" for e, _ in row["grads"])
            say(f"(a) rank {r}: ring attention B={st['ring'][0]} "
                f"T={st['ring'][1]} ({st['ring'][1] // 2} tokens a rank) "
                f"{st['ring'][2]} heads D={st['ring'][3]} bf16 causal="
                f"{row['causal']}: B1-B3 blocks against plain blocks, max"
                f"|dO| {row['o_err']:.3e} (tol {TOL['bfloat16']:g}), dQ/dK/"
                f"dV {errs} (<= {BWD_TOL['bfloat16']:g} of max|grad|); "
                f"launches {row['launches']} (the schedule: {n_b} blocks); "
                f"Ulysses against the plain full attention max "
                f"{row['u_err']:.3e}")
            check(row["o_ok"] and all(ok for _, ok in row["grads"]),
                  f"(a) rank {r}: ring over B1-B3 disagrees with the plain "
                  f"blocks: {row}")
            check(row["launches"] == want,
                  f"(a) rank {r}: launches {row['launches']} != {want}")
            check(row["u_ok"], f"(a) rank {r}: Ulysses {row['u_err']}")

    launches = {"launches": 0, "launches_dkv": 0, "launches_dq": 0}
    L, Ld, Lb = shallow.n_layers, deep.n_layers, bcfg.n_layers
    m, n = st["micro"], st["steps"]
    for key in ("pipe", "seq"):
        for r, res in enumerate(ranks):
            o = res[key]
            for k_, v_ in o["launches"].items():
                launches[k_] += v_
            # remat: B1 twice a layer a slice, B2/B3 once; on pipe a rank
            # runs its half of the layers, on seq a layer's ring runs
            # r + 1 blocks (causal)
            per = (lambda layers: {
                "launches": 2 * layers * m, "launches_dkv": layers * m,
                "launches_dq": layers * m}) if key == "pipe" else (
                lambda layers: {"launches": 2 * layers * m * (r + 1),
                                "launches_dkv": layers * m * (r + 1),
                                "launches_dq": layers * m * (r + 1)})
            lay = (lambda x: x // 2) if key == "pipe" else (lambda x: x)
            want_b = {k_: v_ * n for k_, v_ in per(lay(L)).items()}
            want_c = {k_: v_ * n for k_, v_ in per(lay(Ld)).items()}
            nb = st["bert_steps"]
            want_e = ({"launches": 2 * lay(Lb) * st["bert_micro"] * nb,
                       "launches_dkv": lay(Lb) * st["bert_micro"] * nb,
                       "launches_dq": lay(Lb) * st["bert_micro"] * nb}
                      if key == "pipe" else
                      {"launches": 2 * Lb * 2 * nb, "launches_dkv": Lb * 2 * nb,
                       "launches_dq": Lb * 2 * nb})
            tag = "(b)" if key == "pipe" else "(c)"
            ctrl = (f"; control, the tied embedding's sum over pipe left "
                    f"out: {o['control_gap']:.3e} (> {PS_PARAMS_TOL:g})"
                    if key == "pipe" else "")
            say(f"{tag} rank {r}: GPT-2 small depth {L} fp32 on data=1 x "
                f"{key}=2, B={st['B']} T={st['T']}, {m} microbatches, "
                f"{n} seeded batches: params torch.equal to mesh=None's "
                f"{o['shallow_equal']}, relative L2 gap {o['shallow_gap']:.3e} "
                f"(<= {PS_PARAMS_TOL:g})"
                f"{ctrl}; launches {o['shallow_launches']} (expected "
                f"{want_b})")
            check(o["shallow_gap"] <= PS_PARAMS_TOL,
                  f"{tag} rank {r}: params gap {o['shallow_gap']}")
            check(o["shallow_launches"] == want_b,
                  f"{tag} rank {r}: launches {o['shallow_launches']}")
            if key == "pipe":
                check(o["control_gap"] > PS_PARAMS_TOL,
                      f"(b) rank {r}: the control reads "
                      f"{o['control_gap']}, inside {PS_PARAMS_TOL}")
            losses = np.array(o["deep_losses"])
            rel = np.abs(losses - np.array(ref["deep_losses"])) / np.abs(
                np.array(ref["deep_losses"]))
            share = o["blocks_bytes"] / o["all_blocks_bytes"]
            ts = o["timed"]
            say(f"{tag} rank {r}: GPT-2 small depth {Ld} bf16 mixed "
                f"precision, one batch x {n}: losses {losses.tolist()} "
                f"(mesh=None {ref['deep_losses']}; largest relative "
                f"difference {rel.max():.3e} <= {PS_LOSS_TOL:g}); step "
                f"{o['deep_step_ms']:.1f} ms (host clock after synchronize, "
                f"eager over gloo; mesh=None {ref['deep_step_ms']:.1f} ms, "
                f"its capture included); collectives a step: "
                f"{ps_share(o['deep_stats'])} (over {n} steps); one more "
                f"step under collectives.timed() {o['timed_ms']:.1f} ms, "
                f"gloo {ts['seconds'] * 1e3:.1f} ms "
                f"({ts['seconds'] * 1e3 / o['timed_ms']:.1%}): "
                f"{ps_share(ts)}; block bytes {o['blocks_bytes']:,} of "
                f"{o['all_blocks_bytes']:,} ({share:.3f}); the rank's params "
                f"{o['rank_bytes']:,} of {o['replicated_bytes']:,} "
                f"replicated; peak memory {o['peak_gb']:.2f} GB; guard skips "
                f"{o['deep_skips']}, loss scale {o['deep_scale']:g}; "
                f"launches {o['deep_launches']} (expected {want_c})")
            check(np.isfinite(losses).all(), f"{tag} rank {r}: non-finite")
            check(rel.max() <= PS_LOSS_TOL,
                  f"{tag} rank {r}: losses differ by {rel.max()}")
            check(o["deep_launches"] == want_c,
                  f"{tag} rank {r}: launches {o['deep_launches']}")
            if key == "pipe":
                check(PS_BLOCK_SHARE[0] <= share <= PS_BLOCK_SHARE[1],
                      f"(b) rank {r} holds {share} of the blocks")
            else:
                check(ts["by_kind"]["ring_permute"]["calls"] > 0,
                      "(c): no ring_permute in the timed step")
            bl = np.array(o["bert_losses"])
            brel = np.abs(bl - np.array(ref["bert_losses"])) / np.abs(
                np.array(ref["bert_losses"]))
            what = ("make_pipeline_train_step, n_micro="
                    f"{st['bert_micro']}" if key == "pipe" else
                    f"make_sp_train_step, {st['bert_T'] // 2} tokens a rank")
            say(f"{tag} rank {r}: BERT-base {what}, B={st['bert_B']} "
                f"T={st['bert_T']} bf16: losses {bl.tolist()} "
                f"(make_train_step at mesh=None {ref['bert_losses']}; "
                f"largest relative difference {brel.max():.3e} <= "
                f"{PS_LOSS_TOL:g}); step {o['bert_step_ms']:.1f} ms; "
                f"launches {o['bert_launches']} (expected {want_e})")
            check(brel.max() <= PS_LOSS_TOL,
                  f"{tag} rank {r}: BERT losses differ by {brel.max()}")
            check(o["bert_launches"] == want_e,
                  f"{tag} rank {r}: BERT launches {o['bert_launches']}")
    names = ("mesh=None references (the ranks starting)",
             "two ranks (a)-(c)")
    say("phase 21 wall: " + ", ".join(
        f"{n_} {b - a:.1f} s" for n_, a, b in zip(names, t, t[1:]))
        + f"; total {t[-1] - t[0]:.1f} s; launches on the ranks' main paths "
          f"{launches}")
    return launches


# ---------------------------------------------------------------------------
# phase 22: sharded snapshots, the cluster control plane and recovery
# ---------------------------------------------------------------------------

RC_DEVICE = "cuda"
#: GPT-2 small (dropout 0) through CausalLM: B=8 T=1024, SGD 0.05 with
#: momentum 0.9, seeded batches in order (shuffle off); (a), (b) and (d)
#: at depth 2 in fp32, (c) at full depth in bf16 mixed precision
RC_B, RC_T, RC_LR, RC_MOM, RC_DEPTH = 8, 1024, 0.05, 0.9, 2
#: (steps, snapshot cadence, the step a fault fires) of each part
RC_A = (4, 2, None)
RC_B_PART = (8, 2, 5)
RC_C = (9, 3, 5)
RC_D = (6, 2, 3)
#: the control plane's deadline and the heartbeat's cadence and timeout
RC_SYNC_S, RC_HB_INTERVAL_S, RC_HB_TIMEOUT_S = 10.0, 0.2, 5.0
#: (b)/(d) gathered params against mesh=None's, relative L2; (c) losses
RC_PARAMS_TOL, RC_LOSS_TOL = 1e-5, 2e-2
#: (a) a rank's share of the bytes of the leaves split over model
RC_SHARE = (0.45, 0.55)
#: phase 17 (7)'s gathered snapshots on the writer thread: bytes and ms
#: of each commit (``spine_resilient`` fills it)
SPINE_SNAPSHOT = {}


def rc_settings() -> dict:
    return {"device": RC_DEVICE, "B": RC_B, "T": RC_T, "lr": RC_LR,
            "mom": RC_MOM, "depth": RC_DEPTH, "a": RC_A, "b": RC_B_PART,
            "c": RC_C, "d": RC_D, "sync_s": RC_SYNC_S,
            "hb": (RC_HB_INTERVAL_S, RC_HB_TIMEOUT_S), "gpt": None}


def rc_configs(gpt, st):
    """(GPT-2 small fp32 at depth 2, full depth bf16), dropout 0."""
    base = gpt.gpt_config() if st["gpt"] is None else st["gpt"]
    base = dataclasses.replace(base, dropout=0.0)
    return (dataclasses.replace(base, compute_dtype="float32",
                                n_layers=st["depth"]),
            dataclasses.replace(base, compute_dtype="bfloat16"))


def rc_lm(lm_fit, cfg, st, **kw):
    return lm_fit.CausalLM(cfg, lr=st["lr"], momentum=st["mom"],
                           device=st["device"], **kw).init(0)


def rc_batches(cfg, n: int, st, seed: int):
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    return [DataSet(x, x) for x in ma_ids(cfg.vocab_size, n, st["B"],
                                          st["T"], seed)]


def rc_config(st, part: str, directory: str, **kw):
    from deeplearning4j_tpu_torch.runtime.resilience import ResilienceConfig
    return ResilienceConfig(
        checkpoint_dir=directory, checkpoint_every=st[part][1],
        shuffle=False, cluster_timeout_s=st["sync_s"],
        hb_interval_s=st["hb"][0], hb_timeout_s=st["hb"][1], **kw)


class RcLog:
    """Each step's loss by step (a replayed step keeps its last)."""

    def __init__(self):
        self.by_step = {}

    def iteration_done(self, model, step, score):
        self.by_step[int(step)] = float(score)


def rc_references(torch, st, tmp: str) -> dict:
    """The uninterrupted mesh=None runs in this process on the card, at
    the drills' effective batch with grad_accum=2: (b)'s and (d)'s
    gathered params, written to ``tmp``, and (c)'s losses."""
    from deeplearning4j_tpu_torch.models import gpt, lm_fit

    shallow, deep = rc_configs(gpt, st)
    out = {}
    for part, seed, n_b in (("b", 22, 4), ("d", 24, 3)):
        steps = st[part][0]
        lm = rc_lm(lm_fit, shallow, st, grad_accum=2)
        lm.fit_backprop(rc_batches(shallow, n_b, st, seed),
                        num_epochs=steps // n_b)
        torch.save(lm.params_flat(), os.path.join(tmp, f"{part}_ref.pt"))
        del lm
    lm = rc_lm(lm_fit, deep, st, grad_accum=2, mixed_precision="bf16")
    log = RcLog()
    lm.listeners = [log]
    lm.fit_backprop(rc_batches(deep, 3, st, 23), num_epochs=st["c"][0] // 3)
    out["c_losses"] = log.by_step
    del lm
    return out


def rc_rank(rank: int, rdv: str, out: str, tmp: str, st: dict, part: str,
            world: int) -> None:
    """One rank of phase 22's part ``part`` ("ad", "b" or "c"), results
    pickled."""
    import pickle
    import traceback

    try:
        value = rc_rank_body(rank, rdv, tmp, st, part, world)
        payload = ("ok", value)
    except BaseException:  # noqa: BLE001 — reported to the parent
        payload = ("error", traceback.format_exc())
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(out, "wb") as f:
        pickle.dump(payload, f)


def rc_rank_body(rank: int, rdv: str, tmp: str, st: dict, part: str,
                 world: int) -> dict:
    sys.path.insert(0, REPO)
    import torch

    from deeplearning4j_tpu_torch import resolve_device
    from deeplearning4j_tpu_torch.parallel import mesh as pm

    dev = st["device"]
    torch.set_num_threads(2)
    resolve_device(dev)
    pm.initialize_distributed(f"file://{rdv}", world, rank, device=dev,
                              backend="gloo")
    fn = {"ad": rc_sharded_and_preempt, "b": rc_elastic,
          "c": rc_host_loss}[part]
    return fn(torch, rank, tmp, st)


def rc_cluster(rank: int, members, name: str, st):
    from deeplearning4j_tpu_torch.parallel import multihost
    return multihost.Cluster(rank, members, multihost.StoreKV(),
                             namespace=name, timeout_s=st["sync_s"])


def rc_sharded_and_preempt(torch, rank: int, tmp: str, st: dict) -> dict:
    """(a) and (d) on two ranks."""
    from deeplearning4j_tpu_torch.models import gpt, lm_fit
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.parallel import chaos
    from deeplearning4j_tpu_torch.parallel import mesh as pm
    from deeplearning4j_tpu_torch.runtime import checkpoint as tckpt
    from deeplearning4j_tpu_torch.runtime.resilience import (PreemptionGuard,
                                                             ResilientFit)

    dev = st["device"]
    shallow, _ = rc_configs(gpt, st)
    res = {"launches": {"launches": 0, "launches_dkv": 0, "launches_dq": 0}}

    def book(counts):
        for k, v in counts.items():
            res["launches"][k] += v

    # (a) data=1 x model=2: a cluster-committed sharded snapshot
    steps, _, _ = st["a"]
    mesh = pm.make_mesh(pm.MeshSpec(data=1, model=2), device=dev)
    lm = rc_lm(lm_fit, shallow, st)
    ck = os.path.join(tmp, "a")
    drv = ResilientFit(lm, rc_config(st, "a", ck, max_steps=steps),
                       mesh=mesh, cluster=rc_cluster(rank, (0, 1), "a", st))
    saves = []
    save = drv.manager.save

    def timed_save(step, tree, meta=None, **kw):
        t0 = time.perf_counter()
        path = save(step, tree, meta, **kw)
        saves.append((step, (time.perf_counter() - t0) * 1e3))
        return path

    drv.manager.save = timed_save
    fa.reset_launches()
    # a bounded slice: the last snapshot is the synchronous one at its end
    drv.fit(rc_batches(shallow, steps, st, 21), num_epochs=2)
    ma_sync(torch, st)
    book(fa.launch_counts())
    res["a_launches"] = fa.launch_counts()
    res["a_saves"] = saves
    res["a_latest"] = drv.manager.latest_step()
    # the snapshot read back into this rank's layout, gathered: the
    # momentum the parent's whole restore is held against
    params, ustate, _ = drv._restore_latest(lm, ())
    t0 = time.perf_counter()
    gp, gu = drv._layout(params, ustate, gather=True)
    ma_sync(torch, st)
    res["a_gather_ms"] = (time.perf_counter() - t0) * 1e3
    res["a_restored_equal"] = all(
        torch.equal(a.cpu(), b.cpu()) for a, b in zip(
            lm_fit._sorted_leaves(gp), lm_fit._sorted_leaves(lm.params)))
    if rank == 0:
        t0 = time.perf_counter()
        tckpt.save_pytree(os.path.join(tmp, "a-gathered", "g.npz"),
                          (gp, gu))
        res["a_gathered_write_ms"] = (time.perf_counter() - t0) * 1e3
        torch.save({"params": ma_leaves(torch, lm.params),
                    "momentum": ma_leaves(torch, gu)},
                   os.path.join(tmp, "a-live.pt"))
    del drv, lm, params, ustate, gp, gu
    if dev == "cuda":
        gc_cuda(torch)

    # (d) data=2: rank 1 alone is preempted, both stop at one boundary
    steps, _, at = st["d"]
    mesh = pm.make_mesh(pm.MeshSpec(data=2), device=dev)
    lm = rc_lm(lm_fit, shallow, st)
    guard = PreemptionGuard()
    ck = os.path.join(tmp, "d")
    drv = ResilientFit(lm, rc_config(st, "d", ck), mesh=mesh,
                       cluster=rc_cluster(rank, (0, 1), "d", st),
                       preemption_guard=guard,
                       fault_hook=(chaos.PreemptionChaos(at, guard)
                                   if rank == 1 else None))
    batches = rc_batches(shallow, 3, st, 24)
    drv.fit(batches, num_epochs=steps // 3)
    res["d_stop"] = {"preempted": drv.preempted,
                     "steps": drv.steps_run,
                     "latest": drv.manager.latest_step()}
    del drv, lm
    # the resume on data=1 x model=2 from that snapshot
    mesh = pm.make_mesh(pm.MeshSpec(data=1, model=2), device=dev)
    lm = rc_lm(lm_fit, shallow, st)
    drv = ResilientFit(lm, rc_config(st, "d", ck, resume=True), mesh=mesh,
                       cluster=rc_cluster(rank, (0, 1), "d2", st))
    fa.reset_launches()
    drv.fit(batches, num_epochs=steps // 3)
    ma_sync(torch, st)
    book(fa.launch_counts())
    res["d_launches"] = fa.launch_counts()
    res["d_resume_steps"] = drv.steps_run
    if rank == 0:
        torch.save(lm.params_flat(), os.path.join(tmp, "d_flat.pt"))
    return res


def ma_leaves(torch, tree):
    """``{path: CPU tensor}`` of a tree, in JAX's flatten order."""
    from deeplearning4j_tpu_torch.runtime.checkpoint import \
        _flatten_with_paths
    return {p: t.detach().cpu().clone()
            for p, t in _flatten_with_paths(tree)}


def rc_elastic(torch, rank: int, tmp: str, st: dict) -> dict:
    """(b) on four ranks, then its two controls on the survivors."""
    import shutil

    from deeplearning4j_tpu_torch.models import gpt, lm_fit
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.ops.updaters import tree_map
    from deeplearning4j_tpu_torch.parallel import chaos
    from deeplearning4j_tpu_torch.parallel import mesh as pm
    from deeplearning4j_tpu_torch.runtime.resilience import ResilientFit

    dev = st["device"]
    shallow, _ = rc_configs(gpt, st)
    steps, _, at = st["b"]
    mesh = pm.make_mesh(pm.MeshSpec(data=2, model=2), device=dev)
    lm = rc_lm(lm_fit, shallow, st)
    loss = chaos.DeviceLossChaos(at, [2, 3])
    before = {}

    def hook(step):
        if not loss.fired and step >= loss.at_step:
            before.update(fa.launch_counts())
        loss(step)

    ck = os.path.join(tmp, "b")
    drv = ResilientFit(lm, rc_config(st, "b", ck), mesh=mesh,
                       cluster=rc_cluster(rank, range(4), "b", st),
                       fault_hook=hook)
    batches = rc_batches(shallow, 4, st, 22)
    fa.reset_launches()
    drv.fit(batches, num_epochs=steps // 4)
    ma_sync(torch, st)
    total = fa.launch_counts()
    res = {"evicted": drv.evicted, "before": dict(before),
           "after": {k: v - before.get(k, 0) for k, v in total.items()},
           "launches": total, "recovery": drv.last_recovery,
           "accum": drv.elastic_accum,
           "mesh": None if drv.mesh is None else repr(drv.mesh),
           "members": list(drv.cluster.members)}
    if drv.evicted:
        return res
    if rank == 0:
        torch.save(lm.params_flat(), os.path.join(tmp, "b_flat.pt"))
        # the controls resume from a copy of the step the drill restored
        for name in ("accum1", "momentum0"):
            d = os.path.join(tmp, f"b-{name}")
            os.makedirs(d)
            base = f"ckpt_{drv.last_recovery['restored']}"
            shutil.copytree(os.path.join(ck, base + ".shards"),
                            os.path.join(d, base + ".shards"))
            shutil.copy(os.path.join(ck, base + ".npz.manifest.json"), d)
    survivors = drv.cluster
    survivors.barrier("controls")
    for name in ("accum1", "momentum0"):
        if dev == "cuda":
            gc_cuda(torch)
        lmc = rc_lm(lm_fit, shallow, st)
        ctl = ResilientFit(lmc, rc_config(st, "b", os.path.join(
            tmp, f"b-{name}"), resume=True), mesh=drv.mesh,
            cluster=rc_cluster(rank, survivors.members, name, st))
        if name == "momentum0":
            restore = ctl._restore_latest

            def zeroed(net, upd, restore=restore):
                p, u, meta = restore(net, upd)
                return p, tree_map(torch.zeros_like, u), meta

            ctl._restore_latest = zeroed
        ctl.fit(batches, num_epochs=steps // 4)
        if rank == 0:
            torch.save(lmc.params_flat(),
                       os.path.join(tmp, f"b_{name}.pt"))
    return res


def rc_host_loss(torch, rank: int, tmp: str, st: dict) -> dict:
    """(c) on two ranks: rank 1 SIGKILLs itself at the fault step."""
    import signal

    from deeplearning4j_tpu_torch.models import gpt, lm_fit
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.parallel import mesh as pm
    from deeplearning4j_tpu_torch.parallel import multihost
    from deeplearning4j_tpu_torch.runtime.metrics import ingest_metrics
    from deeplearning4j_tpu_torch.runtime.resilience import ResilientFit

    dev = st["device"]
    _, deep = rc_configs(gpt, st)
    steps, _, at = st["c"]
    mesh = pm.make_mesh(pm.MeshSpec(data=2), device=dev)
    lm = rc_lm(lm_fit, deep, st, mixed_precision="bf16")
    log = RcLog()
    lm.listeners = [log]
    ref = {}

    def kill(step):
        if rank == 1 and step == at:
            # its pending commit lands first, so the drill is the same
            # every run; then a host that says nothing
            ref["drv"].async_ckpt.wait_until_finished()
            with open(os.path.join(tmp, "c-kill-time"), "w") as f:
                f.write(repr(time.time()))
                f.flush()
                os.fsync(f.fileno())
            os.kill(os.getpid(), signal.SIGKILL)

    drv = ResilientFit(lm, rc_config(st, "c", os.path.join(tmp, "c")),
                       mesh=mesh, cluster=multihost.active_cluster(),
                       fault_hook=kill)
    ref["drv"] = drv
    fa.reset_launches()
    ingest_metrics.reset()
    ma_sync(torch, st)
    t0 = time.perf_counter()
    drv.fit(rc_batches(deep, 3, st, 23), num_epochs=steps // 3)
    ma_sync(torch, st)
    svc = drv.service
    return {"service": None if svc is None else {
                "restored": svc.restored, "history": list(svc.history),
                "ingest": ingest_metrics.snapshot()},
            "losses": log.by_step, "recovery": drv.last_recovery,
            "members": list(drv.cluster.members),
            "generation": drv.cluster.generation,
            "accum": drv.elastic_accum,
            "mesh": None if drv.mesh is None else repr(drv.mesh),
            "remeshes": drv.remeshes, "launches": fa.launch_counts(),
            "fit_s": time.perf_counter() - t0}


def rc_shares(tmp: str) -> list:
    """(a): each rank's bytes in ``ckpt_<n>.shards``: its npz file's share
    of the replicated tree's bytes, and its pieces' share of the leaves
    split over model (the odd vocabulary keeps the embedding
    replicated)."""
    d = os.path.join(tmp, "a", f"ckpt_{RC_A[0]}.shards")
    with open(os.path.join(d, "index.json")) as f:
        index = json.load(f)
    item = [2 if t == "bfloat16" else np.dtype(t).itemsize
            for t in index["dtypes"]]
    size = [int(np.prod(s)) * b for s, b in zip(index["shapes"], item)]
    tables = {}
    for k in index["writers"]:
        with open(os.path.join(d, f"shards_p{k}.json")) as f:
            tables[k] = json.load(f)
    split = {info["leaf"] for t in tables.values() for info in t.values()
             if list(info["shape"]) != list(index["shapes"][info["leaf"]])}
    split_bytes = sum(size[i] for i in split)
    out = []
    for k, t in sorted(tables.items()):
        mine = sum(int(np.prod(info["shape"])) * item[info["leaf"]]
                   for info in t.values() if info["leaf"] in split)
        npz = os.path.getsize(os.path.join(d, f"shards_p{k}.npz"))
        out.append((k, npz / sum(size), mine / split_bytes))
    return out


def recovery_phase(torch, fa, card: str) -> dict:
    """Phase 22 (see the module docstring).  Returns the ranks' B1-B3
    launches on the main paths (a)-(d)."""
    import shutil
    import tempfile

    from deeplearning4j_tpu_torch.models import gpt, lm_fit
    from deeplearning4j_tpu_torch.runtime import checkpoint as tckpt
    from deeplearning4j_tpu_torch.runtime import compile_cache

    def say(msg):
        print(f"  {msg} [{card}]")

    compile_cache.clear()
    if RC_DEVICE == "cuda":
        gc_cuda(torch)
    check(not torch.distributed.is_initialized(),
          "phase 22 needs no process group up in this process")
    st = rc_settings()
    shallow, deep = rc_configs(gpt, st)
    tmp = tempfile.mkdtemp(prefix="recovery-")
    t = [time.perf_counter()]
    try:
        # the three groups' eight ranks start up and run side by side
        # while this process runs the references
        started = {"ad": ma_start(rc_rank, tmp, "rc-ad", (tmp, st, "ad", 2)),
                   "c": ma_start(rc_rank, tmp, "rc-c", (tmp, st, "c", 2)),
                   "b": ma_start(rc_rank, tmp, "rc-b", (tmp, st, "b", 4),
                                 world=4)}
        ref = rc_references(torch, st, tmp)
        compile_cache.clear()
        if RC_DEVICE == "cuda":
            gc_cuda(torch)
        t.append(time.perf_counter())
        ad = ma_join(started["ad"], "rc-ad", phase=22)
        c = ma_join(started["c"], "rc-c", phase=22, dies={1: -9})
        t.append(time.perf_counter())
        b = ma_join(started["b"], "rc-b", phase=22)
        t.append(time.perf_counter())
        live = torch.load(os.path.join(tmp, "a-live.pt"))
        tpl = rc_lm(lm_fit, shallow, dict(st, device="cpu")).params
        whole, meta = tckpt.load_pytree_sharded(
            os.path.join(tmp, "a", f"ckpt_{RC_A[0]}.shards"),
            like=(tpl, tpl))
        got = (ma_leaves(torch, whole[0]), ma_leaves(torch, whole[1]))
        a_equal = (all(torch.equal(got[0][k], live["params"][k])
                       for k in live["params"]),
                   all(torch.equal(got[1][k], live["momentum"][k])
                       for k in live["momentum"]))
        with open(os.path.join(tmp, "a", f"ckpt_{RC_A[0]}.npz"
                                         ".manifest.json")) as f:
            a_manifest = json.load(f)
        shares = rc_shares(tmp)
        sharded_bytes = sum(os.path.getsize(os.path.join(
            tmp, "a", f"ckpt_{RC_A[0]}.shards", n)) for n in os.listdir(
            os.path.join(tmp, "a", f"ckpt_{RC_A[0]}.shards")))
        flats = {k: torch.load(os.path.join(tmp, f"{k}.pt"))
                 for k in ("b_ref", "b_flat", "b_accum1", "b_momentum0",
                           "d_ref", "d_flat")}
        with open(os.path.join(tmp, "c-kill-time")) as f:
            kill_time = float(f.read())
        with open(os.path.join(tmp, "d", f"ckpt_{ad[0]['d_stop']['latest']}"
                                         ".npz.manifest.json")) as f:
            d_manifest = json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = {"launches": 0, "launches_dkv": 0, "launches_dq": 0}

    def book(counts):
        for k_, v_ in counts.items():
            launches[k_] += v_

    # (a)
    layout = a_manifest["cluster"]["layout"]
    say(f"(a) GPT-2 small depth {shallow.n_layers} fp32 on data=1 x "
        f"model=2, B={st['B']} T={st['T']}, ResilientFit(mesh=, "
        f"cluster=), a snapshot every {RC_A[1]} for {RC_A[0]} steps: "
        f"manifest layout {layout!r}, members "
        f"{a_manifest['cluster']['members']}; "
        + "; ".join(f"rank {k}'s shards_p{k}.npz {npz:.3f} of the "
                    f"replicated tree's bytes, {sp:.3f} of the model-split "
                    f"leaves'" for k, npz, sp in shares))
    check(layout == "sharded", f"(a) manifest layout {layout}")
    for k, _, sp in shares:
        check(RC_SHARE[0] <= sp <= RC_SHARE[1],
              f"(a) rank {k} holds {sp} of the split leaves")
    say(f"(a) restored whole in this process at mesh=None: params "
        f"torch.equal to the ranks' gathered live params {a_equal[0]}, "
        f"momentum to their gathered restore {a_equal[1]}; each rank's own "
        f"restore equal to its live params "
        f"{[r['a_restored_equal'] for r in ad]}")
    check(all(a_equal) and all(r["a_restored_equal"] for r in ad),
          f"(a) the restore differs: {a_equal}")
    for r, res in enumerate(ad):
        ms = ", ".join(f"step {s} {m:.1f} ms" for s, m in res["a_saves"])
        say(f"(a) rank {r}: cluster-committed sharded saves {ms} "
            f"(the last synchronous, the others on the writer thread); "
            f"launches {res['a_launches']}")
        book(res["launches"])
    sync_ms = max(res["a_saves"][-1][1] for res in ad)
    gathered_ms = ad[0]["a_gather_ms"] + ad[0]["a_gathered_write_ms"]
    spine = (f"{SPINE_SNAPSHOT['write_ms'] / SPINE_SNAPSHOT['commits']:.1f}"
             f" ms a commit of {SPINE_SNAPSHOT['bytes'] / SPINE_SNAPSHOT['commits'] / 1e6:.1f} MB"
             if SPINE_SNAPSHOT.get("commits") else "not measured")
    say(f"(a) the final snapshot: {sharded_bytes / 1e6:.1f} MB in pieces, "
        f"{sync_ms:.1f} ms a rank (the slower); the same state gathered "
        f"(all-gather over model, {ad[0]['a_gather_ms']:.1f} ms) and "
        f"written by rank 0 as one npz ({ad[0]['a_gathered_write_ms']:.1f} "
        f"ms): {gathered_ms:.1f} ms; phase 17 (7)'s gathered GPT-2 small "
        f"bf16 snapshots at depth {SPINE_RF_DEPTH} on the writer thread: "
        f"{spine}")

    # (b)
    gap = ma_rel(torch, flats["b_flat"], flats["b_ref"])
    ctl_acc = ma_rel(torch, flats["b_accum1"], flats["b_ref"])
    ctl_mom = ma_rel(torch, flats["b_momentum0"], flats["b_ref"])
    per = launches_per_step(shallow)
    steps, _, at = RC_B_PART
    for r, res in enumerate(b):
        rec = res["recovery"] or {}
        pre = {k_: v_ * at for k_, v_ in per.items()}
        check(res["before"] == pre, f"(b) rank {r}: launches before the "
                                    f"loss {res['before']}, expected {pre}")
        if r >= 2:
            say(f"(b) rank {r}: evicted {res['evicted']} at step "
                f"{at}; launches {res['before']} before")
            check(res["evicted"] and not any(res["after"].values()),
                  f"(b) rank {r}: {res}")
            book(res["launches"])
            continue
        # two microbatches a step after the re-mesh
        post = {k_: v_ * 2 * (steps - rec["restored"])
                for k_, v_ in per.items()}
        say(f"(b) rank {r}: {res['mesh']}, elastic_accum {res['accum']}, "
            f"members {res['members']}; lost at step {rec['lost_at']}, "
            f"restored step {rec['restored']} (four ranks' pieces, "
            f"resharded); recovery: drain {rec['drain_ms']:.1f} ms, "
            f"agreement {rec['agree_ms']:.1f} ms, re-mesh and rebuild "
            f"{rec['remesh_ms']:.1f} ms, restore {rec['restore_ms']:.1f} "
            f"ms, first step after {rec['first_step_ms']:.1f} ms; B1-B3 "
            f"launches before the re-mesh {res['before']}, after "
            f"{res['after']} (expected {post})")
        check(not res["evicted"] and res["accum"] == 2
              and rec["restored"] == 4, f"(b) rank {r}: {res}")
        check(res["after"] == post, f"(b) rank {r}: launches after the "
                                    f"re-mesh {res['after']}")
        book(res["launches"])
    say(f"(b) survivors' gathered params against the uninterrupted "
        f"mesh=None grad_accum=2 run: torch.equal "
        f"{torch.equal(flats['b_flat'], flats['b_ref'])}, relative L2 "
        f"{gap:.3e} (<= {RC_PARAMS_TOL:g}); control, elastic_accum left at "
        f"1: {ctl_acc:.3e}; control, the momentum lost at the restore: "
        f"{ctl_mom:.3e} (> {RC_PARAMS_TOL:g})")
    check(gap <= RC_PARAMS_TOL, f"(b) params gap {gap}")
    check(ctl_mom > RC_PARAMS_TOL, f"(b) the momentum control reads "
                                   f"{ctl_mom}, inside the bound")

    # (c)
    res = c[0]
    rec = res["recovery"]
    steps, _, at = RC_C
    detect_ms = (rec["detected_at"] - kill_time) * 1e3
    to_step = sum(rec[k] for k in ("drain_ms", "agree_ms", "remesh_ms",
                                   "restore_ms", "first_step_ms"))
    after = sorted(s for s in res["losses"] if s >= rec["restored"])
    rel = max(abs(res["losses"][s] - ref["c_losses"][s])
              / abs(ref["c_losses"][s]) for s in after)
    say(f"(c) GPT-2 small full depth bf16 mixed precision on data=2, "
        f"cluster over the file store, heartbeat {RC_HB_INTERVAL_S} s / "
        f"{RC_HB_TIMEOUT_S} s: rank 1 SIGKILLed at step {at} (exit -9); "
        f"rank 0: members {res['members']} generation {res['generation']}, "
        f"mesh {res['mesh']}, grad_accum {res['accum']}, restored step "
        f"{rec['restored']}, steps lost {rec['lost_at'] - rec['restored']}; "
        f"kill to loss detected {detect_ms:.1f} ms; detected to the end of "
        f"the first step after the restore {to_step:.1f} ms (drain "
        f"{rec['drain_ms']:.1f}, agreement {rec['agree_ms']:.1f}, re-mesh "
        f"{rec['remesh_ms']:.1f}, restore {rec['restore_ms']:.1f}, first "
        f"step {rec['first_step_ms']:.1f}); losses after the recovery "
        f"{[round(res['losses'][s], 5) for s in after]} against the "
        f"uninterrupted mesh=None grad_accum=2 run's largest relative "
        f"difference {rel:.3e} (<= {RC_LOSS_TOL:g}); launches "
        f"{res['launches']}; fit {res['fit_s']:.1f} s")
    check(res["members"] == [0] and res["generation"] == 1
          and res["mesh"] is None and res["accum"] == 2
          and rec["restored"] == 3 and res["remeshes"] == 1,
          f"(c) rank 0: {res}")
    check(max(after) == steps - 1 and rel <= RC_LOSS_TOL
          and np.isfinite([res["losses"][s] for s in after]).all(),
          f"(c) losses differ by {rel}: {res['losses']}")
    # the data service (on by default for a mesh under a cluster): zero
    # replay across the real loss
    svc = res["service"]
    check(svc is not None, "(c) the fit did not read through the data "
                           "service")
    staged = [e_ * 3 + p_ for e_, p_, _ in svc["history"]]
    cut = staged.index(at) + 1 if at in staged else 0
    resumed = staged[cut:]
    say(f"(c) the data service on rank 0: restored reader state "
        f"{svc['restored']}; steps staged before the loss "
        f"{staged[:cut]}, after the restore {resumed}; ingest "
        f"{svc['ingest']}")
    check((svc["restored"] or {}).get("cursor") == divmod(
        rec["restored"], 3)[1], f"(c) restored reader state "
                                f"{svc['restored']}")
    check(resumed == list(range(rec["restored"], steps)),
          f"(c) staged after the restore {resumed}: replayed or skipped")
    check(svc["ingest"]["reassignments"] >= 1,
          f"(c) no reassignment booked: {svc['ingest']}")
    book(res["launches"])

    # (d)
    stops = [r_["d_stop"] for r_ in ad]
    gap_d = ma_rel(torch, flats["d_flat"], flats["d_ref"])
    say(f"(d) data=2, PreemptionChaos on rank 1 alone at step "
        f"{RC_D[2]}: {stops}; the final snapshot's cluster block "
        f"{d_manifest['cluster']}; resumed on data=1 x model=2 for "
        f"{ad[0]['d_resume_steps']} steps: torch.equal to the uninterrupted "
        f"mesh=None run {torch.equal(flats['d_flat'], flats['d_ref'])}, "
        f"relative L2 {gap_d:.3e} (<= {RC_PARAMS_TOL:g}); launches "
        f"{[r_['d_launches'] for r_ in ad]}")
    check(all(s_["preempted"] for s_ in stops)
          and len({(s_["steps"], s_["latest"]) for s_ in stops}) == 1,
          f"(d) the ranks stopped apart: {stops}")
    check(d_manifest["cluster"]["members"] == [0, 1],
          f"(d) {d_manifest['cluster']}")
    check(gap_d <= RC_PARAMS_TOL, f"(d) params gap {gap_d}")
    names = ("mesh=None references (the ranks starting)",
             "(a)+(d) and (c) after them", "(b) after those")
    say("phase 22 wall: " + ", ".join(
        f"{n_} {b_ - a_:.1f} s" for n_, a_, b_ in zip(names, t, t[1:]))
        + f"; total {t[-1] - t[0]:.1f} s; launches on the ranks' main paths "
          f"{launches}")
    return launches


# ---------------------------------------------------------------------------
# phase 23: the data-parallel input and training paths
# ---------------------------------------------------------------------------

DP_DEVICE = "cuda"
#: (a) GPT-2 small through CausalLM, depth 2 fp32, dropout 0, B=8 T=1024,
#: SGD 0.05 with momentum 0.9: 4 row-block batches in the store, 2 epochs,
#: a snapshot every 3 steps
DP_B, DP_T, DP_LR, DP_MOM, DP_DEPTH = 8, 1024, 0.05, 0.9, 2
DP_BATCHES, DP_EPOCHS, DP_EVERY = 4, 2, 3
#: (a) gathered params against mesh=None's, relative L2 (phase 21's rule)
DP_PARAMS_TOL = 1e-5
#: (a) a rank's staged bytes a batch, as a share of the global batch's
DP_BYTES_SHARE = (0.45, 0.55)
#: (c) ResNet-50, B=128 224x224, SGD-Nesterov 0.1/0.9 (phase 16's): bf16
#: for 3 timed steps; the parity in fp32 after the first step, relative
#: L2 against mesh=None: the params and the batch stats (the global
#: moments) within phase 16's card-against-CPU bound (8.622e-4 and
#: 2.170e-7 on the H100, the same in every run).  At lr 0.1
#: on random labels the step is chaotic: mesh=None run twice in fp32
#: (cuDNN free to pick) parts by 3.1e-7 in params after one step and
#: 2.5e-2 after three, and in bf16 data=2 is 4.8e-2 from mesh=None in
#: params after one (tools/resnet_dp_probe.py on the H100); the
#: reference's own data=2 step is 3.5e-3 from its data=1 step after one
#: (fp32, width 8, its --reference mode on the CPU)
DP_RESNET_STEPS = 3
DP_RESNET_TOL = 1e-3
#: (d) word2vec (pair_mode="device", 1 epoch) and GloVe (2 epochs) on
#: text8 at D=100, the ranks' tables against the mean of the two stripes
#: run here, relative L2 over the tables (phase 21's rule; B4 and B5 sum
#: a row's hits in the order their atomics hand out slots, so two runs of
#: one fit differ in the last bits, the AdaGrad sums by ~3e-5 absolute)
DP_EMB_TOL = 1e-5
DP_W2V_EPOCHS, DP_GLOVE_EPOCHS = 1, 2
DP_SYNC_S, DP_HB_INTERVAL_S, DP_HB_TIMEOUT_S = 30.0, 0.5, 10.0


def dp_settings() -> dict:
    return {"device": DP_DEVICE, "B": DP_B, "T": DP_T, "lr": DP_LR,
            "mom": DP_MOM, "depth": DP_DEPTH, "gpt": None,
            "resnet": None, "resnet_b": RESNET_B,
            "resnet_image": RESNET_IMAGE, "t8": None}


def dp_gpt(gpt, st):
    """GPT-2 small at depth 2, fp32, dropout 0."""
    base = gpt.gpt_config() if st["gpt"] is None else st["gpt"]
    return dataclasses.replace(base, dropout=0.0, compute_dtype="float32",
                               n_layers=st["depth"])


def dp_resnet_cfg(res, st):
    return res.resnet50() if st["resnet"] is None else st["resnet"]


def dp_text8(st):
    return text8_sentences() if st["t8"] is None else st["t8"]


def dp_w2v_config(st, **kw):
    from deeplearning4j_tpu_torch.nlp.word2vec import Word2VecConfig
    return Word2VecConfig(min_word_frequency=5, epochs=DP_W2V_EPOCHS,
                          pair_mode="device", kernel="cuda"
                          if st["device"] == "cuda" else "plain",
                          **dict(W2V_CONFIG, **kw))


def dp_glove_config(st, epochs: int = 1):
    from deeplearning4j_tpu_torch.nlp.glove import GloveConfig
    return GloveConfig(epochs=epochs, kernel="cuda"
                       if st["device"] == "cuda" else "plain")


def dp_flat(torch, tree) -> "object":
    """Every leaf of a tree as one fp32 CPU vector (dict keys sorted)."""
    from deeplearning4j_tpu_torch.ops.updaters import tree_leaves
    return torch.cat([t.detach().reshape(-1).float().cpu()
                      for t in tree_leaves(tree)])


def dp_rank(rank: int, rdv: str, out: str, tmp: str, st: dict,
            part: str) -> None:
    """One rank of phase 23's part ``part`` ("a", "c" or "d"), results
    pickled."""
    import pickle
    import traceback

    try:
        sys.path.insert(0, REPO)
        import torch

        from deeplearning4j_tpu_torch import resolve_device
        from deeplearning4j_tpu_torch.parallel import mesh as pm

        torch.set_num_threads(2)
        resolve_device(st["device"])
        pm.initialize_distributed(f"file://{rdv}", 2, rank,
                                  device=st["device"], backend="gloo")
        fn = {"a": dp_service_rank, "c": dp_resnet_rank,
              "d": dp_embeddings_rank}[part]
        payload = ("ok", fn(torch, rank, tmp, st))
    except BaseException:  # noqa: BLE001 — reported to the parent
        payload = ("error", traceback.format_exc())
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(out, "wb") as f:
        pickle.dump(payload, f)


def dp_service_rank(torch, rank: int, tmp: str, st: dict) -> dict:
    """(a) on two ranks: ResilientFit over the DataService on data=2."""
    from deeplearning4j_tpu_torch.cloud.artifacts import LocalArtifactStore
    from deeplearning4j_tpu_torch.datasets.data_service import DataService
    from deeplearning4j_tpu_torch.models import gpt, lm_fit
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.parallel import mesh as pm
    from deeplearning4j_tpu_torch.parallel import multihost
    from deeplearning4j_tpu_torch.runtime.metrics import ingest_metrics
    from deeplearning4j_tpu_torch.runtime.resilience import (
        ResilienceConfig, ResilientFit)

    dev = st["device"]
    mesh = pm.make_mesh(pm.MeshSpec(data=2), device=dev)
    cluster = multihost.active_cluster(timeout_s=DP_SYNC_S)
    lm = lm_fit.CausalLM(dp_gpt(gpt, st), lr=st["lr"], momentum=st["mom"],
                         device=dev).init(0)
    service = DataService.from_store(
        LocalArtifactStore(os.path.join(tmp, "store")), "train",
        cluster=cluster)
    drv = ResilientFit(lm, ResilienceConfig(
        checkpoint_dir=os.path.join(tmp, "a"), checkpoint_every=DP_EVERY,
        shuffle=False, cluster_timeout_s=DP_SYNC_S,
        hb_interval_s=DP_HB_INTERVAL_S, hb_timeout_s=DP_HB_TIMEOUT_S),
        mesh=mesh, cluster=cluster)
    ingest_metrics.reset()
    fa.reset_launches()
    ma_sync(torch, st)
    t0 = time.perf_counter()
    drv.fit(service, num_epochs=DP_EPOCHS)
    ma_sync(torch, st)
    fit_s = time.perf_counter() - t0
    if rank == 0:
        torch.save(lm.params_flat().cpu(), os.path.join(tmp, "a_flat.pt"))
    latest = drv.manager.latest_step()
    return {"ingest": ingest_metrics.snapshot(),
            "launches": fa.launch_counts(), "latest": latest,
            "ingest_state": drv.manager.ingest_state(latest),
            "plan": tuple(service.plan.__dict__.values()),
            "steps": drv.steps_run, "fit_s": fit_s}


def dp_resnet_rank(torch, rank: int, tmp: str, st: dict) -> dict:
    """(c) on two ranks: ResNet-50 on data=2 with the moments over data:
    one fp32 step, and one with each rank's moments alone (the control),
    for the parity; then bf16 steps, timed."""
    from deeplearning4j_tpu_torch.models import resnet as res
    from deeplearning4j_tpu_torch.parallel import collectives as col
    from deeplearning4j_tpu_torch.parallel import mesh as pm

    dev = st["device"]
    cfg = dp_resnet_cfg(res, st)
    mesh = pm.make_mesh(pm.MeshSpec(data=2), device=dev)
    x, y = res.synthetic_batch(0, cfg, st["resnet_b"], st["resnet_image"],
                               device=dev)
    fp32 = dataclasses.replace(cfg, compute_dtype="float32")
    out = {}
    for key, c_, steps, kw in (
            ("fp32", fp32, 1, {}),
            ("control", fp32, 1, {"bn_over_data": False}),
            ("bf16", cfg, DP_RESNET_STEPS, {})):
        init_fn, step_fn = res.make_train_step(c_, mesh=mesh, **kw)
        state = init_fn(torch.Generator().manual_seed(0))
        step_s, losses = [], []
        col.stats.reset()
        with col.timed():
            for _ in range(steps):
                t0 = time.perf_counter()
                state, loss = step_fn(state, x, y)
                losses.append(float(loss))
                step_s.append(time.perf_counter() - t0)
        gloo = col.stats.snapshot()
        if rank == 0:
            torch.save((dp_flat(torch, state.params),
                        dp_flat(torch, state.batch_stats)),
                       os.path.join(tmp, f"c_{key}.pt"))
        out[key] = {"step_s": step_s, "losses": losses,
                    "gloo_s": gloo["seconds"], "gloo_calls": gloo["calls"],
                    "gloo_mb": gloo["bytes"] / 1e6}
        del state, init_fn, step_fn
    return out


def dp_embeddings_rank(torch, rank: int, tmp: str, st: dict) -> dict:
    """(d) on two ranks: word2vec and GloVe fit(mesh=) on data=2, with
    kernel="cuda"; GloVe's two epochs as two fits, so each epoch's
    tables are compared."""
    from deeplearning4j_tpu_torch.nlp.glove import Glove, Shuffles
    from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec
    from deeplearning4j_tpu_torch.ops import fused_glove as fg
    from deeplearning4j_tpu_torch.ops import fused_word2vec as fw
    from deeplearning4j_tpu_torch.parallel import collectives as col
    from deeplearning4j_tpu_torch.parallel import mesh as pm

    dev = st["device"]
    t8 = dp_text8(st)
    mesh = pm.make_mesh(pm.MeshSpec(data=2), device=dev)
    init = torch.load(os.path.join(tmp, "d_init.pt"))
    out = {}
    w = Word2Vec(t8, dp_w2v_config(st), device=dev)
    w.build_vocab()
    fw.reset_launches()
    col.stats.reset()
    ma_sync(torch, st)
    t0 = time.perf_counter()
    with col.timed():
        w.fit(initial_weights=init["w2v"], mesh=mesh)
    ma_sync(torch, st)
    w_s = time.perf_counter() - t0
    torch.save([t.cpu() for t in (w.syn0, w.syn1, w.syn1neg)],
               os.path.join(tmp, f"d_w2v_{rank}.pt"))
    out["w2v"] = {"s": w_s, "launches": fw.launches, "chunks": w.chunks,
                  "words": w._n_positions,
                  "avg_s": col.stats.snapshot()["seconds"]}
    co = dp_cooccurrences(tmp)
    shuffles = Shuffles(13, torch.device(dev))
    state = init["glove"]
    out["glove"] = []
    fg.reset_launches()
    for epoch in range(DP_GLOVE_EPOCHS):
        g = Glove(t8, dp_glove_config(st), device=dev)
        g._shuffles = (lambda e, n, _o=epoch: shuffles(e + _o, n))
        col.stats.reset()
        ma_sync(torch, st)
        t0 = time.perf_counter()
        with col.timed():
            g.fit(initial_weights=state, cooccurrences=co, mesh=mesh)
        ma_sync(torch, st)
        state = g.state
        torch.save([t.cpu() for t in state],
                   os.path.join(tmp, f"d_glove_{rank}_{epoch}.pt"))
        out["glove"].append({"s": time.perf_counter() - t0,
                             "chunks": g.chunks, "loss": g.losses[-1],
                             "avg_s": col.stats.snapshot()["seconds"]})
    out["glove_launches"] = fg.launches
    out["triples"] = int(co[0].size)
    return out


def dp_references(torch, st, tmp: str) -> dict:
    """This process's runs on the card while the ranks start: (a)'s
    mesh=None fit, (c)'s mesh=None ResNet-50 steps, (d)'s two stripes of
    each epoch from the same starting tables, averaged."""
    from deeplearning4j_tpu_torch.models import gpt, lm_fit
    from deeplearning4j_tpu_torch.models import resnet as res
    from deeplearning4j_tpu_torch.ops.updaters import tree_leaves

    out = {}
    lm = lm_fit.CausalLM(dp_gpt(gpt, st), lr=st["lr"], momentum=st["mom"],
                         device=st["device"]).init(0)
    lm.fit_backprop(dp_batches(st), num_epochs=DP_EPOCHS)
    out["a_flat"] = lm.params_flat().cpu()
    del lm
    if st["device"] == "cuda":
        gc_cuda(torch)
    cfg = dp_resnet_cfg(res, st)
    x, y = res.synthetic_batch(0, cfg, st["resnet_b"], st["resnet_image"],
                               device=st["device"])
    init_fn, step_fn = res.make_train_step(
        dataclasses.replace(cfg, compute_dtype="float32"),
        device=st["device"])
    state = init_fn(torch.Generator().manual_seed(0))
    state, _ = step_fn(state, x, y)
    out["c_fp32"] = (dp_flat(torch, state.params),
                     dp_flat(torch, state.batch_stats))
    del state, init_fn, step_fn
    init_fn, step_fn = res.make_train_step(cfg, device=st["device"])
    state = init_fn(torch.Generator().manual_seed(0))
    # the mesh of one is held to it bit for bit: cuDNN deterministic
    with dp_deterministic(torch):
        for _ in range(DP_RESNET_STEPS):
            state, _ = step_fn(state, x, y)
    out["c_state"] = [t.clone() for t in tree_leaves(
        (state.params, state.batch_stats, state.opt_state))]
    out["c_bf16"] = (dp_flat(torch, state.params),
                     dp_flat(torch, state.batch_stats))
    del state, init_fn, step_fn
    if st["device"] == "cuda":
        gc_cuda(torch)
    out.update(dp_stripe_means(torch, st, tmp))
    return out


@contextlib.contextmanager
def dp_deterministic(torch):
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = det


def dp_rel(torch, got, ref) -> float:
    """Relative L2 of two tuples of tables, over all their entries."""
    return ma_rel(torch, dp_flat(torch, list(got)), dp_flat(torch, list(ref)))


def dp_cooccurrences(tmp: str):
    """(d)'s text8 co-occurrence triples, written once by the parent."""
    with np.load(os.path.join(tmp, "d_co.npz")) as z:
        return tuple(z[f"arr_{i}"] for i in range(3))


def dp_batches(st):
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.models import gpt
    return [DataSet(x, x) for x in ma_ids(dp_gpt(gpt, st).vocab_size,
                                          DP_BATCHES, st["B"], st["T"], 25)]


def dp_stripe_means(torch, st, tmp: str) -> dict:
    """(d)'s references: for each epoch, stripe 0 and stripe 1 of the
    chunks from the same tables through B4/B5 (the library's
    ``_stream_epoch`` / ``glove_epoch`` with ``chunk0``), averaged."""
    from deeplearning4j_tpu_torch.nlp import glove as gl
    from deeplearning4j_tpu_torch.nlp import word2vec as wv

    dev = torch.device(st["device"])
    t8 = dp_text8(st)
    init = torch.load(os.path.join(tmp, "d_init.pt"))
    cfg = dp_w2v_config(st)
    w = wv.Word2Vec(t8, cfg, device=dev)
    w.build_vocab()
    codes, points, mask, table, _ = wv.prepare_train_tables(
        w.cache, cfg.table_size)
    indexed = w._index_sentences()
    # the stream the ranks build (the chunk count even)
    W2 = 2 * cfg.window
    pos_chunk = max(8, (cfg.batch_size // W2) // 8 * 8)
    n_stream = int(sum(a.size + 1 for a in indexed))
    nc = -(-n_stream // pos_chunk)
    nc += nc % 2
    stream = np.full(nc * pos_chunk, -1, np.int32)
    off = 0
    for a in indexed:
        stream[off:off + a.size] = a
        off += a.size + 1
    tok = torch.as_tensor(stream, device=dev).long()
    cache = {"tok": tok, "sid": torch.cumsum(tok < 0, 0),
             "n_stream": n_stream, "n_chunks": nc, "pos_chunk": pos_chunk}
    impl = "cuda" if dev.type == "cuda" else "plain"
    state = tuple(t.to(dev) for t in init["w2v"])
    for epoch in range(cfg.epochs):
        halves = []
        for r in range(2):
            chunks = wv._Chunks(dev, impl, pos_chunk * W2, codes, points,
                                mask, table, cfg.use_hs, cfg.negative,
                                wv.Draws(cfg.seed, dev))
            out_r = wv._stream_epoch(tuple(t.clone() for t in state), cache,
                                     chunks, epoch, cfg.epochs, cfg.alpha,
                                     cfg.min_alpha, cfg.window,
                                     chunk0=r * nc // 2, n_run=nc // 2)
            halves.append(tuple(t.clone() for t in out_r))
        state = tuple((a + b) / 2 for a, b in zip(*halves))
    out = {"w2v_mean": [t.cpu() for t in state]}
    co = dp_cooccurrences(tmp)
    rows, cols, x = co
    gcfg = dp_glove_config(st)
    B, P = gcfg.batch_size, rows.size
    NC = max(1, 1 << (-(-P // B) - 1).bit_length())
    NC = max(2, -(-NC // 2) * 2)
    pad = NC * B - P
    rows = np.concatenate([rows, np.zeros(pad, np.int32)])
    cols = np.concatenate([cols, np.zeros(pad, np.int32)])
    x = np.concatenate([x, np.ones(pad, np.float32)])
    args = [torch.as_tensor(a, device=dev) for a in (rows, cols, x)]
    args.append(torch.as_tensor(np.arange(NC * B) < P, dtype=torch.float32,
                                device=dev))
    shuffles = gl.Shuffles(13, dev)
    gstate = tuple(t.to(dev) for t in init["glove"])
    out["glove_means"] = []
    for epoch in range(DP_GLOVE_EPOCHS):
        perm = shuffles(epoch, NC * B).long()
        halves = []
        for r in range(2):
            ext = gl.to_extended(tuple(t.clone() for t in gstate))
            ext, _, _ = gl.glove_epoch(
                ext, *args, perm, float(np.float32(gcfg.alpha)),
                x_max=gcfg.x_max, power=gcfg.weight_power, n_chunks=NC // 2,
                batch=B, impl=impl, chunk0=r * NC // 2)
            halves.append(gl.from_extended(tuple(t.clone() for t in ext)))
        gstate = tuple((a + b) / 2 for a, b in zip(*halves))
        out["glove_means"].append([t.cpu() for t in gstate])
    return out


def dp_mesh_of_one(torch, st, ref: dict, tmp: str, say) -> None:
    """(c) and (d) on an NCCL data mesh of one in this process: ResNet-50's
    captured step, word2vec's and GloVe's fits, each torch.equal to
    mesh=None's."""
    from deeplearning4j_tpu_torch.models import resnet as res
    from deeplearning4j_tpu_torch.nlp.glove import Glove
    from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec
    from deeplearning4j_tpu_torch.ops.updaters import tree_leaves
    from deeplearning4j_tpu_torch.parallel import mesh as pm

    pm.initialize_distributed(f"file://{tmp}/rdv-one", 1, 0,
                              device=st["device"])
    try:
        mesh = pm.make_mesh(pm.MeshSpec(data=1))
        cfg = dp_resnet_cfg(res, st)
        init_fn, step_fn = res.make_train_step(cfg, mesh=mesh)
        state = init_fn(torch.Generator().manual_seed(0))
        x, y = res.synthetic_batch(0, cfg, st["resnet_b"],
                                   st["resnet_image"], device=st["device"])
        with dp_deterministic(torch):
            for _ in range(DP_RESNET_STEPS):
                state, _ = step_fn(state, x, y)
        got = tree_leaves((state.params, state.batch_stats, state.opt_state))
        same = (len(got) == len(ref["c_state"]) and all(
            torch.equal(a, b) for a, b in zip(got, ref["c_state"])))
        how = "captured" if pm.mesh_captures(mesh) else "eager"
        say(f"(c) ResNet-50 bf16 B={st['resnet_b']} on a data mesh of one "
            f"({mesh.backend}, {how}), {DP_RESNET_STEPS} steps: "
            f"params, batch stats and momentum torch.equal to mesh=None "
            f"{same}")
        check(same, "(c) the ResNet-50 mesh of one differs from mesh=None")
        del state, init_fn, step_fn, got
        if st["device"] == "cuda":
            gc_cuda(torch)
        t8 = dp_text8(st)
        init = torch.load(os.path.join(tmp, "d_init.pt"))
        co = dp_cooccurrences(tmp)
        # B4 and B5 sum a row's hits in the order their atomics hand out
        # slots, so two runs of one fit differ in the last bits: the mesh
        # of one is held to mesh=None at DP_EMB_TOL, beside mesh=None run
        # twice
        runs = {}
        for key, m in (("none", None), ("again", None), ("one", mesh)):
            w = Word2Vec(t8, dp_w2v_config(st), device=st["device"])
            w.fit(initial_weights=init["w2v"], mesh=m)
            g = Glove(t8, dp_glove_config(st, DP_GLOVE_EPOCHS),
                      device=st["device"])
            g.fit(initial_weights=init["glove"], cooccurrences=co, mesh=m)
            runs[key] = ((w.syn0, w.syn1, w.syn1neg), g.state)

        def gap(a, b):
            return (all(torch.equal(x_, y_) for x_, y_ in zip(a, b)),
                    dp_rel(torch, a, b))

        gaps = {k: [gap(runs[k][i], runs["none"][i]) for i in range(2)]
                for k in ("again", "one")}
        say(f"(d) on the data mesh of one, against mesh=None: word2vec "
            f"torch.equal {gaps['one'][0][0]}, relative L2 "
            f"{gaps['one'][0][1]:.3e}; GloVe torch.equal "
            f"{gaps['one'][1][0]}, relative L2 {gaps['one'][1][1]:.3e} (<= "
            f"{DP_EMB_TOL:g}); mesh=None run twice: word2vec "
            f"{gaps['again'][0][1]:.3e}, GloVe {gaps['again'][1][1]:.3e}")
        check(max(gaps["one"][0][1], gaps["one"][1][1]) <= DP_EMB_TOL,
              f"(d) the mesh of one differs from mesh=None: {gaps}")
    finally:
        torch.distributed.destroy_process_group()


def dp_phase(torch, fa, fw, fg, card: str) -> dict:
    """Phase 23 (see the module docstring).  Returns the ranks' launches
    on the main paths: B1-B3 of (a), B4 and B5 of (d)."""
    import shutil
    import tempfile

    from deeplearning4j_tpu_torch.cloud.artifacts import LocalArtifactStore
    from deeplearning4j_tpu_torch.datasets.data_service import \
        write_sharded_batches
    from deeplearning4j_tpu_torch.models import gpt
    from deeplearning4j_tpu_torch.nlp.glove import count_cooccurrences
    from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec
    from deeplearning4j_tpu_torch.runtime import compile_cache

    def say(msg):
        print(f"  {msg} [{card}]")

    compile_cache.clear()
    if DP_DEVICE == "cuda":
        gc_cuda(torch)
    check(not torch.distributed.is_initialized(),
          "phase 23 needs no process group up in this process")
    st = dp_settings()
    tmp = tempfile.mkdtemp(prefix="dataparallel-")
    t = [time.perf_counter()]
    try:
        batches = dp_batches(st)
        write_sharded_batches(LocalArtifactStore(os.path.join(tmp, "store")),
                              "train", batches)
        t8 = dp_text8(st)
        w = Word2Vec(t8, dp_w2v_config(st), device="cpu")
        w.build_vocab()
        V, D = len(w.cache), W2V_CONFIG["vector_size"]
        gen = torch.Generator().manual_seed(23)
        from deeplearning4j_tpu_torch.nlp.vocab import build_vocab
        from deeplearning4j_tpu_torch.nlp.text import DefaultTokenizerFactory
        tok = DefaultTokenizerFactory()
        gcache = build_vocab(t8, tok, 1)
        co = count_cooccurrences(t8, tok, gcache)
        Vg = len(gcache)
        init = {"w2v": ((torch.rand((V, D), generator=gen) - 0.5) / D,
                        torch.randn((V, D), generator=gen) * 0.01,
                        torch.randn((V, D), generator=gen) * 0.01),
                "glove": ((torch.rand((Vg, D), generator=gen) - 0.5) / D,
                          (torch.rand((Vg, D), generator=gen) - 0.5) / D,
                          torch.zeros(Vg), torch.zeros(Vg),
                          torch.full((Vg, D), 1e-8),
                          torch.full((Vg, D), 1e-8),
                          torch.full((Vg,), 1e-8), torch.full((Vg,), 1e-8))}
        torch.save(init, os.path.join(tmp, "d_init.pt"))
        np.savez(os.path.join(tmp, "d_co.npz"), *co)
        t.append(time.perf_counter())
        # the three groups' six ranks start and run side by side while
        # this process runs the references
        started = {p: ma_start(dp_rank, tmp, f"dp-{p}", (tmp, st, p))
                   for p in ("a", "c", "d")}
        ref = dp_references(torch, st, tmp)
        t.append(time.perf_counter())
        compile_cache.clear()
        if DP_DEVICE == "cuda":
            gc_cuda(torch)
        a = ma_join(started["a"], "dp-a", phase=23)
        d = ma_join(started["d"], "dp-d", phase=23)
        c = ma_join(started["c"], "dp-c", phase=23)
        t.append(time.perf_counter())
        dp_mesh_of_one(torch, st, ref, tmp, say)
        t.append(time.perf_counter())
        flats = {k: torch.load(os.path.join(tmp, f"{k}.pt"))
                 for k in ("a_flat", "c_fp32", "c_control", "c_bf16")}
        w2v = [torch.load(os.path.join(tmp, f"d_w2v_{r}.pt"))
               for r in range(2)]
        glv = [[torch.load(os.path.join(tmp, f"d_glove_{r}_{e}.pt"))
                for e in range(DP_GLOVE_EPOCHS)] for r in range(2)]
        with open(os.path.join(tmp, "a", f"ckpt_{a[0]['latest']}"
                                         ".npz.manifest.json")) as f:
            a_manifest = json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = {"launches": 0, "launches_dkv": 0, "launches_dq": 0,
                "w2v": 0, "glove": 0}

    # (a)
    cfg = dp_gpt(gpt, st)
    batch_bytes = 2 * st["B"] * st["T"] * 4
    gap = ma_rel(torch, flats["a_flat"], ref["a_flat"])
    per = launches_per_step(cfg)
    steps = DP_BATCHES * DP_EPOCHS
    for r, res_ in enumerate(a):
        ing = res_["ingest"]
        share = ing["bytes_staged"] / max(ing["batches_staged"], 1) \
            / batch_bytes
        say(f"(a) rank {r}: GPT-2 small depth {cfg.n_layers} fp32 B="
            f"{st['B']} T={st['T']} on data=2 through "
            f"ResilientFit(cluster=) over DataService.from_store "
            f"({DP_BATCHES} row-block batches, {DP_EPOCHS} epochs, a "
            f"snapshot every {DP_EVERY}): plan {res_['plan']}, "
            f"{ing['batches_staged']} batches staged, "
            f"{ing['bytes_staged']} bytes = {share:.3f} of a global batch's "
            f"{batch_bytes} a batch, stage {ing['stage_ms']:.1f} ms in all "
            f"({ing['stage_ms'] / max(ing['batches_staged'], 1):.2f} ms a "
            f"batch), prefetch depth high-water {ing['depth_hw']}, seed "
            f"agreements {ing['seed_agreements']}; fit {res_['fit_s']:.1f} "
            f"s; B1-B3 launches {res_['launches']}")
        check(DP_BYTES_SHARE[0] <= share <= DP_BYTES_SHARE[1],
              f"(a) rank {r} staged {share} of a global batch")
        check(ing["batches_staged"] == steps and res_["steps"] == steps,
              f"(a) rank {r}: {ing}")
        want = {k_: v_ * steps for k_, v_ in per.items()}
        check(res_["launches"] == want, f"(a) rank {r}: launches "
                                        f"{res_['launches']}, expected "
                                        f"{want}")
        for k_, v_ in res_["launches"].items():
            launches[k_] += v_
    ingest = a_manifest.get("ingest") or {}
    latest = a[0]["latest"]
    say(f"(a) gathered params against the mesh=None run here: relative L2 "
        f"{gap:.3e} (<= {DP_PARAMS_TOL:g}), torch.equal "
        f"{torch.equal(flats['a_flat'], ref['a_flat'])}; the newest "
        f"manifest (step {latest}) ingest block {ingest}")
    check(gap <= DP_PARAMS_TOL, f"(a) params gap {gap}")
    check((ingest.get("epoch"), ingest.get("cursor"))
          == divmod(latest, DP_BATCHES), f"(a) manifest ingest {ingest}")

    # (c)
    gaps = {k: [ma_rel(torch, flats[f"c_{k}"][i], ref[f"c_{r_}"][i])
                for i in range(2)]
            for k, r_ in (("fp32", "fp32"), ("control", "fp32"),
                          ("bf16", "bf16"))}
    for r, res_ in enumerate(c):
        k_ = res_["bf16"]
        ms = float(np.median(k_["step_s"])) * 1e3
        say(f"(c) rank {r}: ResNet-50 bf16, {st['resnet_b'] // 2} rows a "
            f"rank of B={st['resnet_b']}, {DP_RESNET_STEPS} steps, losses "
            f"{[round(v, 4) for v in k_['losses']]}; step {ms:.1f} ms "
            f"(median, host clock; first {k_['step_s'][0] * 1e3:.1f} ms), "
            f"{st['resnet_b'] / (ms / 1e3):.1f} images/s for the pair; gloo "
            f"{k_['gloo_calls']} collectives, {k_['gloo_mb']:.1f} MB, "
            f"{k_['gloo_s'] * 1e3:.1f} ms = "
            f"{k_['gloo_s'] / sum(k_['step_s']):.1%} of the steps "
            f"(collectives.timed()); the fp32 step "
            f"{res_['fp32']['step_s'][0] * 1e3:.1f} ms, the control's "
            f"{res_['control']['step_s'][0] * 1e3:.1f} ms; first losses "
            f"fp32 {res_['fp32']['losses'][0]:.6f}, control "
            f"{res_['control']['losses'][0]:.6f}")
    say(f"(c) rank 0 against mesh=None here, relative L2 (params, batch "
        f"stats): fp32 after the first step {gaps['fp32'][0]:.3e}, "
        f"{gaps['fp32'][1]:.3e} (<= {DP_RESNET_TOL:g}); the control with "
        f"each rank's moments alone {gaps['control'][0]:.3e}, "
        f"{gaps['control'][1]:.3e} (both outside); bf16 after {DP_RESNET_STEPS} steps, printed only (the "
        f"step is chaotic at lr 0.1): {gaps['bf16'][0]:.3e}, "
        f"{gaps['bf16'][1]:.3e}")
    check(max(gaps["fp32"]) <= DP_RESNET_TOL,
          f"(c) ResNet-50 data=2 gaps {gaps['fp32']}")
    check(min(gaps["control"]) > DP_RESNET_TOL,
          f"(c) the per-rank moments control reads {gaps['control']}, "
          f"inside the bound")

    # (d)
    w_equal = all(torch.equal(x_, y_) for x_, y_ in zip(*w2v))
    w_err = dp_rel(torch, w2v[0], ref["w2v_mean"])
    g_equal = [all(torch.equal(x_, y_) for x_, y_ in zip(glv[0][e],
                                                          glv[1][e]))
               for e in range(DP_GLOVE_EPOCHS)]
    g_err = [dp_rel(torch, glv[0][e], ref["glove_means"][e])
             for e in range(DP_GLOVE_EPOCHS)]
    for r, res_ in enumerate(d):
        wv_ = res_["w2v"]
        say(f"(d) rank {r}: word2vec text8 D={W2V_CONFIG['vector_size']} "
            f"pair_mode=device kernel=cuda, {DP_W2V_EPOCHS} epoch on "
            f"data=2: {wv_['chunks']} chunks, B4 launches "
            f"{wv_['launches']}, {wv_['s']:.2f} s, "
            f"{wv_['words'] / 2 / wv_['s']:.1f} words/s a rank (its half "
            f"of the stream), the averaging "
            f"{wv_['avg_s'] * 1e3:.1f} ms = {wv_['avg_s'] / wv_['s']:.1%} "
            f"of the epoch; GloVe {res_['triples']} triples, "
            + "; ".join(f"epoch {e}: {g_['chunks']} chunks, loss "
                        f"{g_['loss']:.6f}, {g_['s']:.2f} s, "
                        f"{res_['triples'] / g_['s']:.1f} triples/s, the "
                        f"averaging {g_['avg_s'] / g_['s']:.1%}"
                        for e, g_ in enumerate(res_["glove"]))
            + f"; B5 launches {res_['glove_launches']}")
        check(wv_["launches"] == wv_["chunks"] > 0,
              f"(d) rank {r}: B4 launches {wv_['launches']} for "
              f"{wv_['chunks']} chunks")
        g_chunks = sum(g_["chunks"] for g_ in res_["glove"])
        check(res_["glove_launches"] == g_chunks > 0,
              f"(d) rank {r}: B5 launches {res_['glove_launches']} for "
              f"{g_chunks} chunks")
        launches["w2v"] += wv_["launches"]
        launches["glove"] += res_["glove_launches"]
    say(f"(d) the ranks' tables equal each other: word2vec {w_equal}, "
        f"GloVe by epoch {g_equal}; against the mean of the two stripes run "
        f"here from the same tables and draws through B4/B5, relative L2: "
        f"word2vec {w_err:.3e}, GloVe {[f'{e_:.3e}' for e_ in g_err]} "
        f"(<= {DP_EMB_TOL:g})")
    check(w_equal and all(g_equal), "(d) the ranks' tables differ")
    check(w_err <= DP_EMB_TOL and max(g_err) <= DP_EMB_TOL,
          f"(d) against the stripes' mean: {w_err}, {g_err}")
    names = ("set-up", "references here (the ranks starting)",
             "the ranks after them", "the meshes of one")
    say("phase 23 wall: " + ", ".join(
        f"{n_} {b_ - a_:.1f} s" for n_, a_, b_ in zip(names, t, t[1:]))
        + f"; total {t[-1] - t[0]:.1f} s; launches on the ranks' main paths "
          f"{launches}")
    return launches



# ---------------------------------------------------------------------------
# phase 24: the scale-out runtime
# ---------------------------------------------------------------------------

SC_DEVICE = "cuda"
#: (a) GPT-2 small (full width and depth, bf16, seeded weights) served on
#: data=1 x pipe=2 and data=1 x seq=2 by two gloo ranks: the first 8
#: requests of phase 10's seeded burst, 64 tokens each, n_slots 8
SC_REQS, SC_SEED = 8, 24
#: (b) word2vec (phase 7's text8 config, 3 epochs) and GloVe (phase 8's
#: defaults) over 2 in-process workers and 4 shards, against the same two
#: rounds run by one worker: relative L2 of the averaged tables.  B4 and B5
#: sum a row's hits in the order their atomics hand out slots, so two runs
#: of one fit part in the last bits (PERF.md section 6: mesh=None twice
#: 1.2e-8 for word2vec, 1.1e-6-1.6e-6 for GloVe; this phase read
#: 7.4e-9-7.8e-9 and 5.6e-7-6.5e-7 on the H100)
SC_WORKERS, SC_SHARDS = 2, 4
SC_W2V_TOL, SC_GLOVE_TOL = 5e-8, 2e-6
#: (c) LeNet-MNIST (phase 9's bf16 conf) over 2 spawned worker processes,
#: 4 jobs of 512 data/mnist images (2 epochs a job); a worker is killed
#: 0.2 s into its first job; the reaper's window
SC_MP_JOBS, SC_MP_EPOCHS, SC_MP_KILL_S, SC_STALE_S = 4, 2, 0.2, 3.0
#: (c) "above chance" on the 512-image test split: twice chance
SC_MP_MIN_ACC = 0.2
#: (d) Hogwild on LeNet-MNIST: 2 threads, 16 batches of 128, SGD 0.05
#: with momentum 0.5 (cuDNN deterministic for the one-worker parity)
SC_HW_BATCHES, SC_HW_LR, SC_HW_MOM = 16, 0.05, 0.5
#: (e) the chaos drills: 64 text8 shards
SC_CHAOS_SHARDS, SC_P_FAIL, SC_P_CORRUPT = 64, 0.25, 0.5
SC_DEADLINE_S = 600.0


def sc_settings() -> dict:
    return {"device": SC_DEVICE, "gpt": None, "reqs": SC_REQS,
            "slots": GEN_SLOTS, "tokens": BURST_TOKENS}


def sc_gpt(gpt, st):
    """GPT-2 small, bf16 (phase 10's config)."""
    return gen_config(gpt) if st["gpt"] is None else st["gpt"]


def sc_requests(cfg, st):
    """The first requests of phase 10's burst, each prompt cut to leave
    its tokens room in the model (GPT-2 small's 1024 cut none)."""
    room = cfg.max_len - st["tokens"]
    return [(p[:room], t, s) for p, t, s in burst_requests(cfg)[:st["reqs"]]]


def sc_sync(torch, device) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def sc_record(eng) -> list:
    """Wrap ``eng``'s start / advance / release so every request's sampled
    tokens are kept, on a leader and a follower alike: ``[(prompt bytes,
    tokens)]`` in the order the slots were released."""
    live, done = {}, []
    start, advance, release = eng.start, eng.advance, eng.release

    def rec_start(prompt, **kw):
        bucket, slot, first = start(prompt, **kw)
        live[(bucket, slot)] = (np.asarray(prompt).tobytes(), [int(first)])
        return bucket, slot, first

    def rec_advance(bucket):
        out = advance(bucket)
        for (b, slot), (_, toks) in live.items():
            if b == bucket:
                toks.append(int(out[slot]))
        return out

    def rec_release(bucket, slot):
        if (bucket, slot) in live:
            done.append(live.pop((bucket, slot)))
        return release(bucket, slot)

    eng.start, eng.advance, eng.release = rec_start, rec_advance, rec_release
    return done


def sc_rank(rank: int, rdv: str, out: str, tmp: str, st: dict) -> None:
    """One rank of (a), results pickled."""
    import pickle
    import traceback

    try:
        value = sc_rank_body(rank, rdv, tmp, st)
        payload = ("ok", value)
    except BaseException:  # noqa: BLE001 — reported to the parent
        payload = ("error", traceback.format_exc())
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(out, "wb") as f:
        pickle.dump(payload, f)


def sc_rank_body(rank: int, rdv: str, tmp: str, st: dict) -> dict:
    sys.path.insert(0, REPO)
    import torch

    from deeplearning4j_tpu_torch import resolve_device
    from deeplearning4j_tpu_torch.models import gpt
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.parallel import mesh as pm
    from deeplearning4j_tpu_torch.runtime.quantize import tree_bytes
    from deeplearning4j_tpu_torch.serving.decode import (ContinuousBatcher,
                                                         DecodeEngine)

    dev = st["device"]
    torch.set_num_threads(2)
    resolve_device(dev)
    pm.initialize_distributed(f"file://{rdv}", 2, rank, device=dev,
                              backend="gloo")
    cfg = sc_gpt(gpt, st)
    params = gpt.init_params(torch.Generator(device=dev).manual_seed(
        SC_SEED), cfg, dev)
    reqs = sc_requests(cfg, st)
    res = {}
    for axis in ("pipe", "seq"):
        mesh = pm.make_mesh(pm.MeshSpec(data=1, **{axis: 2}), device=dev)
        eng = DecodeEngine(cfg, params, n_slots=st["slots"], mesh=mesh,
                           device=dev)
        record = sc_record(eng)
        fa.reset_launches()
        sc_sync(torch, dev)
        t0 = time.perf_counter()
        b = ContinuousBatcher(eng, default_max_tokens=st["tokens"])
        part = {"leads": b.leads}
        if b.leads:
            handles = [b.submit(p, max_tokens=st["tokens"], temperature=t,
                                seed=s) for p, t, s in reqs]
            part["outs"] = [h.result(timeout=600).tolist() for h in handles]
        b.close()
        sc_sync(torch, dev)
        part["s"] = time.perf_counter() - t0
        part["b1"] = fa.launch_counts()["launches"]
        part["tokens"] = [(k, t[:st["tokens"]]) for k, t in record]
        part["weight_bytes"] = tree_bytes(eng.current_params())
        part["kv_bytes"] = eng.kv_bytes_per_slot * eng.n_slots
        part["axis_rank"] = mesh.coords[axis]
        res[axis] = part
        del b, eng, mesh
        if dev == "cuda":
            gc_cuda(torch)
    res["replicated_bytes"] = tree_bytes(gpt.serving_params(cfg, params))
    return res


def sc_serving_reference(torch, fa, gpt, st, say):
    """(a)'s mesh=None engine on the same weights and requests: its tokens
    by prompt, as a list, and its B1 launches."""
    from deeplearning4j_tpu_torch.serving.decode import DecodeEngine

    cfg = sc_gpt(gpt, st)
    params = gpt.init_params(torch.Generator(device=SC_DEVICE).manual_seed(
        SC_SEED), cfg, SC_DEVICE)
    reqs = sc_requests(cfg, st)
    eng = DecodeEngine(cfg, params, n_slots=st["slots"], device=SC_DEVICE)
    fa.reset_launches()
    outs, wall, _ = serve_burst(torch, eng, reqs, st["tokens"])
    b1 = fa.launch_counts()["launches"]
    want = {np.asarray(p).tobytes(): o.tolist()
            for (p, _, _), o in zip(reqs, outs)}
    say(f"(a) the mesh=None engine here: {len(reqs)} requests of phase "
        f"10's burst (prompts {min(len(p) for p, _, _ in reqs)}-"
        f"{max(len(p) for p, _, _ in reqs)} tokens, {st['tokens']} tokens "
        f"each, half sampled at {BURST_TEMP}) in {wall:.2f} s, B1 "
        f"launches {b1} (the decode path attends over the KV cache "
        f"without B1, in both packages)")
    del eng, params
    return want, [o.tolist() for o in outs], b1


def sc_serving_checks(ranks, want, want_list, ref_b1, say) -> int:
    """(a) each rank's tokens against mesh=None's; B1 launches a rank."""
    b1 = 0
    for axis in ("pipe", "seq"):
        for r, res in enumerate(ranks):
            part = res[axis]
            got = dict(part["tokens"])
            same = (len(part["tokens"]) == len(want)
                    and all(got.get(k) == v for k, v in want.items()))
            say(f"(a) data=1 x {axis}=2, rank {r} ({axis} {part['axis_rank']}"
                f", {'leader' if part['leads'] else 'follower'}): "
                f"{len(part['tokens'])} requests in {part['s']:.2f} s, "
                f"tokens equal to mesh=None's {same}; B1 launches "
                f"{part['b1']}; weights {part['weight_bytes']} bytes "
                f"(replicated {res['replicated_bytes']}), KV "
                f"{part['kv_bytes']} bytes ({GEN_SLOTS} slots)")
            check(same, f"(a) {axis}=2 rank {r}: tokens differ from "
                        f"mesh=None's")
            if part["leads"]:
                check(part["outs"] == want_list,
                      f"(a) {axis}=2: the leader's handles differ")
            check(part["weight_bytes"] == res["replicated_bytes"],
                  f"(a) {axis}=2 rank {r} holds {part['weight_bytes']} of "
                  f"{res['replicated_bytes']} weight bytes")
            check(part["b1"] == ref_b1, f"(a) {axis}=2 rank {r}: B1 launched "
                                        f"{part['b1']} times, mesh=None "
                                        f"{ref_b1}")
            b1 += part["b1"]
    return b1


def sc_rounds_by_one(performer, shards, aggregator, per_round: int):
    """The runner's rounds (``per_round`` shards each, from the last
    round's average) made by ONE performer, one job after another."""
    from deeplearning4j_tpu_torch.parallel.coordinator import Job

    current, jobs = None, []
    for r in range(0, len(shards), per_round):
        aggregator.reset()
        for shard in shards[r:r + per_round]:
            if current is not None:
                performer.update(current)
            job = Job(work=shard)
            performer.perform(job)
            jobs.append((performer.chunks, getattr(performer, "words", 0),
                         getattr(performer, "triples", 0)))
            aggregator.accumulate(job)
        current = aggregator.aggregate()
    return current, jobs


def sc_tables_rel(got, want) -> float:
    num = sum(float(np.sum((np.asarray(g, np.float64)
                            - np.asarray(w, np.float64)) ** 2))
              for g, w in zip(got, want) if w is not None)
    den = sum(float(np.sum(np.asarray(w, np.float64) ** 2))
              for w in want if w is not None)
    return (num / max(den, 1e-300)) ** 0.5


class ScJobClock:
    """Each ``perform`` of a performer class, (start, end) on the host
    clock, while installed: how far the runner's worker threads overlap."""

    def __init__(self, cls):
        self.cls, self.spans, self.lock = cls, [], threading.Lock()

    def __enter__(self):
        self.orig = self.cls.perform
        orig, spans, lock = self.orig, self.spans, self.lock

        def perform(perf, job):
            t0 = time.perf_counter()
            try:
                orig(perf, job)
            finally:
                with lock:
                    spans.append((t0, time.perf_counter()))
        self.cls.perform = perform
        return self

    def __exit__(self, *exc):
        self.cls.perform = self.orig

    def overlap(self, wall: float) -> float:
        return sum(b - a for a, b in self.spans) / max(wall, 1e-9)


def sc_embeddings(torch, fw, fg, t8, say) -> dict:
    """(b): the distributed word2vec and GloVe trainers on text8."""
    from deeplearning4j_tpu_torch.nlp import distributed as nd
    from deeplearning4j_tpu_torch.nlp.glove import GloveConfig
    from deeplearning4j_tpu_torch.nlp.word2vec import Word2VecConfig

    out = {}
    kernel = "cuda" if SC_DEVICE == "cuda" else "plain"
    cases = (("word2vec", "B4", fw, nd.train_word2vec_distributed,
              nd.Word2VecPerformer, nd.Word2VecJobAggregator,
              Word2VecConfig(min_word_frequency=5, epochs=3, kernel=kernel,
                             **W2V_CONFIG), SC_W2V_TOL, 1),
             ("GloVe", "B5", fg, nd.train_glove_distributed,
              nd.GlovePerformer, nd.GloveJobAggregator,
              GloveConfig(kernel=kernel), SC_GLOVE_TOL, 2))
    for name, kname, mod, train, perf_cls, agg_cls, cfg, tol, per_unit \
            in cases:
        mod.reset_launches()
        sc_sync(torch, SC_DEVICE)
        with ScJobClock(perf_cls) as clock:
            t0 = time.perf_counter()
            wv = train(t8, cfg, n_workers=SC_WORKERS, n_shards=SC_SHARDS,
                        device=SC_DEVICE)
            sc_sync(torch, SC_DEVICE)
            wall = time.perf_counter() - t0
        n = mod.launches
        tr = wv.tracker
        counts = {k: tr.count(k) for k in ("jobs_done", "jobs_failed",
                                           "jobs_dropped")}
        # the same rounds by one worker (a comparison: not counted)
        ref, jobs = sc_rounds_by_one(
            perf_cls(wv.cache, cfg, device=SC_DEVICE),
            nd.shard_sentences(t8, SC_SHARDS), agg_cls(), SC_WORKERS)
        rel = sc_tables_rel(wv.tables, ref)
        units = sum(j[per_unit] for j in jobs) * cfg.epochs
        unit = "words" if per_unit == 1 else "triples"
        chunks = sum(j[0] for j in jobs)
        say(f"(b) {name} on text8 D={cfg.vector_size}, {SC_WORKERS} "
            f"in-process workers, {SC_SHARDS} shards, {cfg.epochs} epochs a "
            f"job: {wall:.2f} s, {units / wall:.1f} {unit}/s "
            f"({units} {unit} in all), {kname} launches {n} for {chunks} "
            f"chunks, tracker {counts}, the workers' jobs overlap "
            f"{clock.overlap(wall):.2f}x; the averaged tables against the "
            f"same rounds by one worker: relative L2 {rel:.3e} (<= {tol:g})")
        check(counts["jobs_done"] == SC_SHARDS and counts["jobs_failed"] == 0
              and counts["jobs_dropped"] == 0, f"(b) {name}: {counts}")
        check(n == chunks > 0 or SC_DEVICE != "cuda",
              f"(b) {name}: {kname} launched {n} times for {chunks} chunks")
        check(rel <= tol, f"(b) {name}: tables {rel} from one worker's")
        check(bool(torch.isfinite(wv.vectors).all()),
              f"(b) {name}: non-finite vectors")
        out[name] = n
    return out


def sc_multiprocess(torch, ln, say) -> None:
    """(c): MultiProcessRunner, 2 worker processes, LeNet-MNIST, one
    worker SIGKILLed mid-job."""
    import signal

    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel import scaleout as so
    from deeplearning4j_tpu_torch.parallel import transport as tp
    from deeplearning4j_tpu_torch.parallel.performers import (
        ParameterAveragingAggregator, params_on)

    train, test = mnist_split(True), mnist_split(False)
    x, y = np.asarray(train.features), np.asarray(train.labels)
    per = len(x) // SC_MP_JOBS
    jobs = [DataSet(x[i * per:(i + 1) * per],
                    y[i * per:(i + 1) * per]).batch_by(LENET_B)
            for i in range(SC_MP_JOBS)]

    class Recorded(ParameterAveragingAggregator):
        def __init__(self):
            super().__init__()
            self.seen = []

        def accumulate(self, job):
            self.seen.append((job.worker_id, job.retries))
            super().accumulate(job)

    conf = ln.lenet_conf().to_json()
    spec = ("deeplearning4j_tpu_torch.parallel.performers:"
            "MultiLayerNetworkPerformer", (conf,),
            {"num_epochs": SC_MP_EPOCHS, "seed": 0, "device": SC_DEVICE})
    agg = Recorded()
    runner = tp.MultiProcessRunner(so.CollectionJobIterator(jobs), spec, agg,
                                   n_workers=2, stale_after_s=SC_STALE_S)
    tracker, marks, errors = runner.tracker, {}, []

    def holding(wid):
        with tracker._lock:
            return wid in tracker._jobs

    def wait(cond, what):
        end = time.perf_counter() + 300
        while not cond():
            if time.perf_counter() > end:
                raise TimeoutError(what)
            time.sleep(0.002)
        return time.perf_counter()

    def killer():
        try:
            t0 = time.perf_counter()
            marks["join"] = wait(lambda: len(tracker.workers()) >= 2,
                                 "workers never joined") - t0
            wait(lambda: holding("proc-worker-1"), "worker 1 never had a job")
            time.sleep(SC_MP_KILL_S)
            check(holding("proc-worker-1"), "(c) worker 1 finished its job "
                                            "before the kill")
            os.kill(runner.processes[1].pid, signal.SIGKILL)
            kill = time.perf_counter()
            reaped = wait(lambda: tracker.count("workers_reaped") >= 1,
                          "the reaper never fired")
            taken = wait(requeued_taken, "the requeued job was never taken")
            marks.update(kill_to_reap=reaped - kill, reap_to_taken=taken
                         - reaped)
        except BaseException as e:  # noqa: BLE001 — raised below
            errors.append(e)

    def requeued_taken():
        """The reaped worker's job is held by (or done by) another."""
        with tracker._lock:
            held = [j.retries for j in tracker._jobs.values()]
        return any(r >= 1 for r in held + [r for _, r in agg.seen])

    watcher = threading.Thread(target=killer, daemon=True)
    watcher.start()
    t0 = time.perf_counter()
    averaged = runner.run(timeout_s=SC_DEADLINE_S, join_timeout_s=120)
    wall = time.perf_counter() - t0
    watcher.join(60)
    check(not errors, f"(c) {errors}")
    alive = [p.is_alive() for p in runner.processes]
    codes = [p.exitcode for p in runner.processes]
    leaves = [np.asarray(v) for p in averaged for v in p.values()]
    finite = all(np.isfinite(a).all() for a in leaves)
    nbytes = sum(a.nbytes for a in leaves)
    net = MultiLayerNetwork(ln.lenet_conf(), device=SC_DEVICE)
    net.params = params_on(averaged, net.device)
    acc = net.evaluate(test).accuracy()
    counts = {k: tracker.count(k) for k in ("jobs_done", "jobs_failed",
                                            "jobs_dropped", "workers_reaped",
                                            "updates_discarded")}
    say(f"(c) MultiProcessRunner, 2 spawned workers on the card, LeNet-MNIST "
        f"bf16, {SC_MP_JOBS} jobs of {per} data/mnist images ({SC_MP_EPOCHS} "
        f"epochs a job): join {marks.get('join', 0) * 1e3:.1f} ms; worker 1 "
        f"SIGKILLed {SC_MP_KILL_S} s into its first job, reaped "
        f"{marks.get('kill_to_reap', 0) * 1e3:.1f} ms later (window "
        f"{SC_STALE_S} s), its requeued job taken "
        f"{marks.get('reap_to_taken', 0) * 1e3:.1f} ms after the reap; "
        f"{wall:.2f} s in all; results (worker, retries) {agg.seen}; "
        f"tracker {counts}; exit codes {codes}; a job's params "
        f"{nbytes} bytes up and the current params {nbytes} bytes down to "
        f"each worker, {4 * nbytes} bytes across the wire a round of 2 jobs;"
        f" test accuracy {acc:.4f} on {len(test)} images")
    check(finite, "(c) non-finite averaged params")
    check(counts["jobs_done"] == SC_MP_JOBS and counts["jobs_dropped"] == 0
          and counts["workers_reaped"] >= 1, f"(c) {counts}")
    check(any(r >= 1 for _, r in agg.seen), "(c) no job was requeued")
    check(codes[1] == -signal.SIGKILL and not any(alive),
          f"(c) processes {codes}, alive {alive}")
    check(acc >= SC_MP_MIN_ACC, f"(c) accuracy {acc}")


def sc_hogwild(torch, ln, say) -> None:
    """(d): HogwildTrainer on LeNet-MNIST."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops.updaters import (apply_descent,
                                                       dl4j_updater,
                                                       tree_map)
    from deeplearning4j_tpu_torch.parallel.hogwild import HogwildTrainer

    dev = SC_DEVICE
    train, test = mnist_split(True), mnist_split(False)

    def batches(data, n):
        x = torch.as_tensor(np.asarray(data.features)[:n * LENET_B]).to(dev)
        y = torch.as_tensor(np.asarray(data.labels)[:n * LENET_B]).to(dev)
        return list(zip(x.split(LENET_B), y.split(LENET_B)))

    jobs, held = batches(train, SC_HW_BATCHES), batches(test, 4)
    net = MultiLayerNetwork(ln.lenet_conf(), device=dev).init(seed=0)

    def loss_fn(p, x, y, gen):
        return net.loss(p, x, y, gen, train=True)

    def held_loss(p):
        with torch.no_grad():
            return float(sum(loss_fn(p, x, y, None) for x, y in held)) / 4

    upd = dl4j_updater(lr=SC_HW_LR, momentum=SC_HW_MOM)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        t = HogwildTrainer(loss_fn, upd, num_workers=2, device=dev)
        sc_sync(torch, dev)
        t0 = time.perf_counter()
        p2 = t.fit(net.params, jobs, seed=0)
        sc_sync(torch, dev)
        wall = time.perf_counter() - t0
        before, after = held_loss(net.params), held_loss(p2)
        by_worker = {}
        for j in t.tracker.updates():
            by_worker[j.worker_id] = by_worker.get(j.worker_id, 0) + 1
        # one worker against a plain loop of the same steps and folds
        one = HogwildTrainer(loss_fn, upd, num_workers=1, local_steps=2,
                             device=dev).fit(net.params, jobs[:6], seed=0)
        gv = torch.func.grad_and_value(loss_fn)
        gen = torch.Generator(device=dev).manual_seed(0)
        local = glob = net.params
        ustate = upd.init(local)
        for j, (x, y) in enumerate(jobs[:6]):
            pulled = p = local
            for i in range(2):
                grads, _ = gv(p, x, y, gen)
                with torch.no_grad():
                    u, ustate = upd.update(ustate, grads, p, j + i, 1)
                    p = apply_descent(p, u)
            local = p
            glob = tree_map(lambda g, a, b: g + (a - b), glob, p, pulled)
        equal = all(torch.equal(a, b) for pa, pb in zip(one, glob)
                    for a, b in zip(pa.values(), pb.values()))
    finally:
        torch.backends.cudnn.deterministic = det
    say(f"(d) HogwildTrainer, 2 threads on {dev}, LeNet-MNIST bf16, "
        f"{SC_HW_BATCHES} jobs of {LENET_B}: {wall:.2f} s "
        f"({SC_HW_BATCHES / wall:.1f} steps/s), jobs by worker {by_worker}, "
        f"held-out loss {before:.4f} -> {after:.4f}; one worker against a "
        f"plain loop of the same 12 steps and folds: torch.equal {equal}")
    check(t.tracker.count("iterations") == SC_HW_BATCHES
          and len(t.tracker.updates()) == SC_HW_BATCHES,
          f"(d) {t.tracker.count('iterations')} jobs processed")
    check(after < before, f"(d) the loss did not fall: {before} -> {after}")
    check(equal, "(d) one worker differs from the plain loop")


class ScHistogram:
    """(e)'s numeric job: the shard's vocabulary histogram on the card."""

    def __init__(self, torch, cache, tok):
        self.torch, self.cache, self.tok = torch, cache, tok

    def perform(self, job):
        torch = self.torch
        ids = [self.cache.index_of(w) for s in job.work for w in self.tok(s)
               if w in self.cache]
        job.result = {"h": torch.bincount(
            torch.tensor(ids, device=SC_DEVICE),
            minlength=len(self.cache)).float()}

    def update(self, *args):
        pass


def sc_chaos(torch, t8, say) -> None:
    """(e): the word-count runner under injected crashes, and corrupted
    results against the hardened accumulator."""
    from deeplearning4j_tpu_torch.nlp import distributed as nd

    shards = nd.shard_sentences(t8, SC_CHAOS_SHARDS)
    clean = nd.word_count_distributed(shards, n_workers=SC_WORKERS)
    # every injected fault logs (a traceback each): counted below instead
    quiet = logging.getLogger("deeplearning4j_tpu_torch.parallel.scaleout")
    level = quiet.level
    quiet.setLevel(logging.CRITICAL)
    try:
        sc_chaos_runs(torch, t8, shards, clean, say)
    finally:
        quiet.setLevel(level)


def sc_chaos_runs(torch, t8, shards, clean, say) -> None:
    from deeplearning4j_tpu_torch.nlp import distributed as nd
    from deeplearning4j_tpu_torch.nlp.text import DefaultTokenizerFactory
    from deeplearning4j_tpu_torch.nlp.vocab import build_vocab
    from deeplearning4j_tpu_torch.parallel import scaleout as so
    from deeplearning4j_tpu_torch.parallel.chaos import chaos_factory

    factory = chaos_factory(nd.WordCountPerformer, p_fail=SC_P_FAIL,
                            seed=SC_SEED)
    runner = so.DistributedRunner(
        so.CollectionJobIterator(shards), factory, nd.WordCountAggregator(),
        n_workers=SC_WORKERS, router_cls=so.HogWildWorkRouter,
        max_job_retries=100)
    counts = runner.run(timeout_s=SC_DEADLINE_S)
    fails = sum(p.injected["fail"] for p in factory.instances)
    tr = runner.tracker
    say(f"(e) word count over {len(shards)} text8 shards under "
        f"chaos_factory(p_fail={SC_P_FAIL}): {fails} injected crashes, "
        f"jobs_failed {tr.count('jobs_failed')}, jobs_dropped "
        f"{tr.count('jobs_dropped')}; {len(counts)} words, equal to the "
        f"clean run's {counts == clean}")
    check(counts == clean, "(e) the counts under crashes differ")
    check(fails > 0 and tr.count("jobs_failed") == fails
          and tr.count("jobs_dropped") == 0, f"(e) crashes {fails}")

    tok = DefaultTokenizerFactory()
    cache = build_vocab(t8, tok, 5)
    factory = chaos_factory(lambda: ScHistogram(torch, cache, tok),
                            p_corrupt=SC_P_CORRUPT, seed=SC_SEED,
                            corrupt=lambda r: {"h": r["h"] * float("nan")})
    runner = so.DistributedRunner(
        so.CollectionJobIterator(shards), factory, so.WorkAccumulator(),
        n_workers=SC_WORKERS, router_cls=so.HogWildWorkRouter)
    mean = runner.run(timeout_s=SC_DEADLINE_S)
    corrupt = sum(p.injected["corrupt"] for p in factory.instances)
    rejected = runner.tracker.count("updates_rejected")
    say(f"(e) vocabulary histograms on the card under "
        f"chaos_factory(p_corrupt={SC_P_CORRUPT}, a NaN hook): {corrupt} "
        f"corrupted, {rejected} rejected by the WorkAccumulator; the mean "
        f"finite {bool(torch.isfinite(mean['h']).all())}")
    check(corrupt > 0 and rejected == corrupt,
          f"(e) {corrupt} corrupted, {rejected} rejected")
    check(bool(torch.isfinite(mean["h"]).all()), "(e) non-finite mean")


def scaleout_phase(torch, fa, fw, fg, ln, t8, card: str) -> dict:
    """Phase 24 (see the module docstring).  Returns the main paths'
    launches: B1 of (a)'s ranks, B4 and B5 of (b)'s trainers."""
    import shutil
    import tempfile

    from deeplearning4j_tpu_torch.models import gpt
    from deeplearning4j_tpu_torch.runtime import compile_cache

    def say(msg):
        print(f"  {msg} [{card}]")

    compile_cache.clear()
    if SC_DEVICE == "cuda":
        gc_cuda(torch)
    check(not torch.distributed.is_initialized(),
          "phase 24 needs no process group up in this process")
    st = sc_settings()
    tmp = tempfile.mkdtemp(prefix="scaleout-")
    t = [time.perf_counter()]
    marks = []

    def mark(name):
        t.append(time.perf_counter())
        marks.append(name)

    # (a)'s two ranks start and serve, and (c)'s runner spawns its worker
    # processes (its lines printed when it is done), while this process
    # runs (a)'s reference, (b), (d) and (e)
    from concurrent.futures import ThreadPoolExecutor
    mp_lines = []
    mp_pool = ThreadPoolExecutor(1)
    try:
        started = ma_start(sc_rank, tmp, "sc", (tmp, st))
        mp = mp_pool.submit(sc_multiprocess, torch, ln, mp_lines.append)
        want, want_list, ref_b1 = sc_serving_reference(torch, fa, gpt, st,
                                                       say)
        mark("(a) mesh=None")
        emb = sc_embeddings(torch, fw, fg, t8, say)
        mark("(b)")
        sc_hogwild(torch, ln, say)
        mark("(d)")
        sc_chaos(torch, t8, say)
        mark("(e)")
        mp.result()
        for line in mp_lines:
            say(line)
        mark("(c) after them")
        ranks = ma_join(started, "sc", phase=24)
        mark("(a) ranks joined")
    finally:
        mp_pool.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    b1 = sc_serving_checks(ranks, want, want_list, ref_b1, say)
    launches = {"launches": b1, "w2v": emb["word2vec"],
                "glove": emb["GloVe"]}
    say("phase 24 wall: " + ", ".join(
        f"{n_} {b_ - a_:.1f} s" for n_, a_, b_ in zip(marks, t, t[1:]))
        + f"; total {t[-1] - t[0]:.1f} s; launches on the main paths "
          f"{launches}")
    return launches


# ---------------------------------------------------------------------------
# phase 25: NLP and periphery
# ---------------------------------------------------------------------------

#: phase 25's sizes.  The RNTN runs at the reference's published width
#: (deeplearning4j_tpu/nlp/rntn.py:138, numHidden=25, 5 classes,
#: max_nodes 64) over 2,304 text8 windows of 24 words (at most 47 nodes
#: a tree): 2,048 fit full-batch, 256 held out.  Barnes-Hut t-SNE runs
#: below full width (N=300, 30 iterations): its negative forces are the
#: host SpTree's Python, the same in both packages.
NP_SETTINGS = dict(width=24, n_trees=2304, n_train=2048, epochs=20,
                   parity_epochs=3, dim=25, n_classes=5, max_nodes=64,
                   tsne_check_iter=20, bh_n=300, bh_iter=30, tag_train=400,
                   tag_test=100, tag_window=5, tag_epochs=10,
                   news_docs=4000, news_train=3200, news_epochs=5, seed=0)
#: SentiWordNet.classify's seven classes onto the treebank's five
NP_SENTIMENT = {"strong_negative": 0, "negative": 1, "weak_negative": 1,
                "neutral": 2, "weak_positive": 3, "positive": 3,
                "strong_positive": 4}
NP_RNTN_RTOL = 1e-4      # the first epochs' losses, card against the CPU
NP_KMEANS_TOL = 1e-4     # centroids, card against the CPU
NP_TSNE_RTOL = 1e-3      # exact t-SNE at 20 iterations, card against CPU
NP_BH_RTOL = 1e-5        # Barnes-Hut, card against the CPU
NP_DEADLINE_S = 600.0    # a worker's job, at most


def np_worker_init() -> None:
    """A phase 25 worker process: the repo importable, two torch
    threads (the card's host has eight cores for this process and
    four workers)."""
    sys.path.insert(0, REPO)
    import torch

    torch.set_num_threads(2)


def np_windows(st, start: int, n: int):
    """``n`` consecutive text8 windows of ``st["width"]`` words, from
    window ``start``."""
    with open(TEXT8) as f:
        words = f.read().split()
    w = st["width"]
    return [words[(start + i) * w:(start + i + 1) * w] for i in range(n)]


def np_parse_job(st):
    """(trees, five-class labels, (c)'s windows, their tags, seconds):
    SentiWordNet labels and TreeParser trees of the RNTN windows, then
    default_tagger's tags of the sequence-labelling windows."""
    from deeplearning4j_tpu_torch.nlp.pos import default_tagger
    from deeplearning4j_tpu_torch.nlp.sentiment import SentiWordNet
    from deeplearning4j_tpu_torch.nlp.treeparser import TreeParser

    t0 = time.perf_counter()
    swn, parser = SentiWordNet(), TreeParser()
    texts = [" ".join(w) for w in np_windows(st, 0, st["n_trees"])]
    labels = [NP_SENTIMENT[swn.classify(t)] for t in texts]
    trees = [parser.parse(t, label=lab) for t, lab in zip(texts, labels)]
    tagger = default_tagger()
    seqs = np_windows(st, st["n_trees"], st["tag_train"] + st["tag_test"])
    tags = [[t for _, t in tagger.tag(s)] for s in seqs]
    return trees, labels, seqs, tags, time.perf_counter() - t0


def np_rntn_weights(st, vocab_size: int) -> dict:
    """Initial RNTN weights at the reference's init_params scales
    (rntn.py:143-156), drawn from RandomState(seed): both devices start
    from them through rntn.params_from_numpy."""
    d, k = st["dim"], st["n_classes"]
    rng = np.random.RandomState(st["seed"])
    return {"embed": rng.randn(vocab_size, d) * 0.1,
            "W": rng.randn(2 * d, d) / np.sqrt(2 * d),
            "b": np.zeros(d),
            "V": rng.randn(d, 2 * d, 2 * d) / (2 * d),
            "U": rng.randn(d, k) / np.sqrt(d),
            "bc": np.zeros(k)}


def np_rntn_model(st, trees, device):
    from deeplearning4j_tpu_torch.nlp import rntn

    vocab = rntn.build_vocab(trees)
    cfg = rntn.RNTNConfig(vocab_size=len(vocab), dim=st["dim"],
                          n_classes=st["n_classes"],
                          max_nodes=st["max_nodes"])
    return rntn.RNTN(cfg, trees, device=device, params=rntn.params_from_numpy(
        np_rntn_weights(st, len(vocab)), device))


def np_rntn_cpu_job(st, trees):
    """The first epochs' losses of the fit on the CPU, and seconds."""
    t0 = time.perf_counter()
    losses = np_rntn_model(st, trees, "cpu").fit(st["parity_epochs"])
    return losses, time.perf_counter() - t0


def np_bh_job(st, x, device: str):
    """Barnes-Hut t-SNE of ``x`` on ``device`` (TsneConfig's defaults,
    ``bh_iter`` iterations): (embedding, seconds)."""
    from deeplearning4j_tpu_torch.plot.tsne import BarnesHutTsne, TsneConfig

    t0 = time.perf_counter()
    y = BarnesHutTsne(TsneConfig(max_iter=st["bh_iter"]),
                      device=device).fit_transform(x)
    return y, time.perf_counter() - t0


def np_tsne_job(st, p, y0, device: str):
    """Exact t-SNE from P and ``y0`` for ``tsne_check_iter`` iterations
    on ``device``: (embedding, last KL)."""
    from deeplearning4j_tpu_torch.plot.tsne import Tsne, TsneConfig

    ts = Tsne(TsneConfig(max_iter=st["tsne_check_iter"]), device=device)
    return ts.embed(p, y0), ts.kl_


def np_get(job, what: str):
    """A worker job's result, failing the phase if it raised or hung."""
    try:
        return job.get(NP_DEADLINE_S)
    except Exception as e:                       # noqa: BLE001
        raise SmokeFailure(f"phase 25 {what}: {type(e).__name__}: {e}")


def np_softmax_net(n_in: int, n_out: int, lr: float):
    """One softmax layer over ``n_in`` inputs, fp32, AdaGrad."""
    from deeplearning4j_tpu_torch.nn.conf import (LayerKind,
                                                  NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf = (NeuralNetConfiguration.builder()
            .n_in(n_in).lr(lr).use_adagrad(True).compute_dtype("float32")
            .list(1)
            .override(0, kind=LayerKind.OUTPUT, n_out=n_out,
                      activation="softmax", loss_function="mcxent")
            .pretrain(False).backward(True).build())
    return MultiLayerNetwork(conf, device="cuda").init(seed=0)


def np_rel(a, b) -> float:
    """max |a - b| over max |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def np_vectors(torch, fw, t8, st, card, say):
    """(b)'s word vectors: text8's word2vec at phase 7's config, one
    epoch through B4.  Returns the Word2Vec and B4's launches."""
    from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec, Word2VecConfig

    w2v = Word2Vec(t8, Word2VecConfig(min_word_frequency=5, epochs=1,
                                      **W2V_CONFIG), device="cuda")
    fw.reset_launches()
    t0 = time.perf_counter()
    w2v.fit()
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    n = fw.launches
    check(w2v.chunks > 0 and n == w2v.chunks,
          f"phase 25 word2vec: B4 launched {n} times for {w2v.chunks} "
          f"chunks")
    check(bool(w2v.syn0.isfinite().all()), "phase 25: non-finite vectors")
    say(f"(b) word2vec on text8, one epoch: V={len(w2v.cache)}, "
        f"D={w2v.syn0.shape[1]}, {w2v.chunks} chunks = {n} B4 launches, "
        f"{sec * 1e3:.1f} ms [{card}]")
    check(len(w2v.cache) > 1000, f"phase 25: vocabulary {len(w2v.cache)}")
    return w2v, n


def np_kmeans(torch, x, st, say, card) -> None:
    """(b) KMeansClustering at the reference defaults on the card, and
    Lloyd on the CPU from the same initial centroids."""
    from deeplearning4j_tpu_torch.clustering.kmeans import (KMeansClustering,
                                                            KMeansConfig,
                                                            lloyd)

    km = KMeansClustering(KMeansConfig(), device="cuda")
    t0 = time.perf_counter()
    km.fit(x)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    cfg = km.config
    c, labels, inertia, iters = lloyd(x.cpu(), km.init_centroids_.cpu(),
                                      cfg.max_iterations, cfg.tolerance)
    err = float((km.centroids.cpu() - c).abs().max())
    same = bool(torch.equal(km.labels_.cpu(), labels))
    sizes = torch.bincount(labels, minlength=cfg.n_clusters).tolist()
    say(f"(b) k-means k={cfg.n_clusters} on {x.shape[0]} vectors: "
        f"{km.n_iter_} iterations (CPU {iters}), inertia {km.inertia_:.4f} "
        f"(CPU {float(inertia):.4f}), cluster sizes {sizes}; card against "
        f"the CPU from the same initial centroids: labels equal {same}, "
        f"centroids max|diff| {err:.3e} (tolerance {NP_KMEANS_TOL:g}); "
        f"{ms:.1f} ms with k-means++ seeding [{card}]")
    check(same and err <= NP_KMEANS_TOL and km.n_iter_ == iters,
          "phase 25 k-means: the card and the CPU disagree")


def np_tsne(torch, pool, x_host, words, st, say, card):
    """(b) exact t-SNE of every word vector at TsneConfig's defaults,
    its page, and the 20-iteration comparison's CPU job."""
    import tempfile

    from deeplearning4j_tpu_torch.plot.plotter import render_embedding_html
    from deeplearning4j_tpu_torch.plot.tsne import (Tsne, TsneConfig,
                                                    joint_probabilities)

    cfg = TsneConfig()
    t0 = time.perf_counter()
    p = joint_probabilities(x_host.astype(np.float64), cfg.perplexity)
    host_ms = (time.perf_counter() - t0) * 1e3
    ts = Tsne(cfg, device="cuda")
    y0 = ts.initial_y(len(words)).numpy()
    cpu_job = pool.apply_async(np_tsne_job, (st, p, y0, "cpu"))
    ts.embed(p[:64, :64], y0[:64])                    # warm-up, small
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y = ts.embed(p, y0)
    dev_ms = (time.perf_counter() - t0) * 1e3
    kls = ts.kl_history_.cpu().numpy()
    check(np.isfinite(y).all() and y.shape == (len(words), 2),
          "phase 25 t-SNE: bad embedding")
    check(kls[-1] < kls[cfg.exaggeration_iters],
          f"phase 25 t-SNE: KL {kls[-1]:.4f} not below iteration "
          f"{cfg.exaggeration_iters}'s {kls[cfg.exaggeration_iters]:.4f}")
    say(f"(b) exact t-SNE of {len(words)} words (perplexity "
        f"{cfg.perplexity:g}, {cfg.max_iter} iterations, float64): P on the "
        f"host {host_ms:.1f} ms, the device loop {dev_ms:.1f} ms "
        f"({dev_ms / cfg.max_iter:.3f} ms an iteration, host clock after "
        f"synchronize, P's upload included); KL {kls[0]:.4f} at iteration "
        f"0 (exaggerated), {kls[cfg.exaggeration_iters]:.4f} at "
        f"{cfg.exaggeration_iters}, {kls[-1]:.4f} at the end [{card}]")
    check_ts = Tsne(TsneConfig(max_iter=st["tsne_check_iter"]),
                    device="cuda")
    t0 = time.perf_counter()
    y20 = check_ts.embed(p, y0)
    ms20 = (time.perf_counter() - t0) * 1e3
    busy = sum(device_ms_by_kernel(torch, lambda: check_ts.embed(p, y0))
               .values())
    say(f"(b) exact t-SNE, {st['tsne_check_iter']} iterations: {ms20:.2f} "
        f"ms (host clock after synchronize, P's upload included), device "
        f"busy {busy:.2f} ms of it in a profiled repeat ({busy / ms20:.1%}) "
        f"[{card}]")
    with tempfile.TemporaryDirectory() as tmp:
        page = render_embedding_html(words, y, os.path.join(tmp, "emb.html"))
        html = open(page).read()
        check(f'"w": "{words[0]}"' in html and "<svg" in html,
              "phase 25: the embedding page lacks its words")
        say(f"(b) embedding page: {len(html)} bytes, {len(words)} words")
    return y20, cpu_job


def np_newsgroups(torch, st, say, card) -> None:
    """(d) NewsGroupsLoader(tfidf=True) feeding a softmax classifier on
    the card."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.newsgroups import NewsGroupsLoader

    t0 = time.perf_counter()
    loader = NewsGroupsLoader(tfidf=True, n_docs=st["news_docs"],
                              seed=st["seed"], device="cuda")
    host_ms = (time.perf_counter() - t0) * 1e3
    tfidf = loader.vectorizer.transform(loader.texts)
    check(tfidf.device.type == "cuda" and torch.equal(
        tfidf.cpu(), torch.from_numpy(loader.data.features)),
        "phase 25 newsgroups: the TF-IDF tensor differs from its numpy "
        "values")
    labels = torch.from_numpy(loader.data.labels).cuda()
    n = st["news_train"]
    net = np_softmax_net(tfidf.shape[1], labels.shape[1], lr=0.1)
    t0 = time.perf_counter()
    net.fit_backprop(DataSet(tfidf[:n], labels[:n]).batch_by(100),
                     num_epochs=st["news_epochs"])
    torch.cuda.synchronize()
    fit_ms = (time.perf_counter() - t0) * 1e3
    acc = net.evaluate(DataSet(tfidf[n:], labels[n:])).accuracy()
    say(f"(d) newsgroups surrogate: {loader.num_examples} documents, "
        f"{len(loader.label_names)} labels, TF-IDF {tuple(tfidf.shape)} on "
        f"the card equal to its numpy values; loading {host_ms:.1f} ms, fit "
        f"{st['news_epochs']} epochs {fit_ms:.1f} ms; held-out accuracy "
        f"{acc:.4f} on {loader.num_examples - n} documents [{card}]")
    check(acc >= 0.9, f"phase 25 newsgroups: held-out accuracy {acc:.4f}")


def np_rntn(torch, pool, trees, labels, st, say, card):
    """(a) the RNTN fit on the card and RNTNEval over the held-out trees;
    the same fit's first epochs start on the CPU in a worker.  Returns
    the card's first losses and that job."""
    from deeplearning4j_tpu_torch.nlp.rntn import RNTNEval

    train, held = trees[:st["n_train"]], trees[st["n_train"]:]
    cpu_job = pool.apply_async(np_rntn_cpu_job, (st, train))
    model = np_rntn_model(st, train, "cuda")
    k = st["parity_epochs"]
    losses = model.fit(k)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += model.fit(st["epochs"] - k - 1)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    epoch_ms = sec / (st["epochs"] - k - 1) * 1e3
    last = []
    by = device_ms_by_kernel(torch, lambda: last.extend(model.fit(1)))
    losses += last
    busy = sum(by.values())
    top = ", ".join(f"{name[:48]} {ms:.2f}" for name, ms in sorted(
        by.items(), key=lambda kv: -kv[1])[:4])
    ev = RNTNEval(st["n_classes"])
    ev.eval(model, held)
    internal = sum((t.size() - 1) // 2 for t in held)
    sizes = [t.size() for t in trees]
    say(f"(a) RNTN dim {st['dim']} over {len(trees)} text8 windows of "
        f"{st['width']} words ({min(sizes)}-{max(sizes)} nodes, labels "
        f"{np.bincount(labels, minlength=st['n_classes']).tolist()}, V="
        f"{model.cfg.vocab_size}): {st['epochs']} full-batch AdaGrad epochs "
        f"over {len(train)} trees, loss {losses[0]:.5f} -> {losses[-1]:.5f}; "
        f"an epoch {epoch_ms:.2f} ms, {len(train) / (epoch_ms / 1e3):.1f} "
        f"trees/s (host clock after synchronize, epochs {k + 1}-"
        f"{st['epochs'] - 1}); the last epoch profiled: device busy "
        f"{busy:.2f} ms ({busy / epoch_ms:.1%} of an unprofiled epoch), "
        f"device ms by kernel {top} [{card}]")
    say(f"(a) RNTNEval over {len(held)} held-out trees: {ev.confusion.sum()} "
        f"internal nodes (expected {internal}), node accuracy "
        f"{ev.accuracy():.4f}, root accuracy {ev.root_accuracy():.4f}")
    check(losses[-1] < losses[0], "phase 25 RNTN: the loss did not fall")
    check(int(ev.confusion.sum()) == internal,
          "phase 25 RNTNEval: node count differs from the internal nodes")
    return losses[:k], cpu_job


def np_rntn_parity(losses, cpu_job, say) -> None:
    """(a)'s first epochs on the card against the CPU worker's."""
    k = len(losses)
    cpu, cpu_s = np_get(cpu_job, "RNTN on the CPU")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, cpu))
    say(f"(a) the first {k} epochs' losses on the card against the CPU from "
        f"the same weights: {losses} vs {cpu}, max relative difference "
        f"{rel:.3e} (tolerance {NP_RNTN_RTOL:g}; the CPU took {cpu_s:.1f} s "
        f"in a worker)")
    check(rel <= NP_RNTN_RTOL, "phase 25 RNTN: card and CPU losses differ")


def np_sequences(torch, w2v, seqs, tags, st, say, card) -> None:
    """(c) windows of word vectors -> a softmax tagger on the card ->
    Viterbi over its emissions, on the card and on the CPU."""
    from deeplearning4j_tpu_torch.nlp.moving_window import \
        Word2VecDataSetIterator
    from deeplearning4j_tpu_torch.nlp.word_vectors import WordVectors
    from deeplearning4j_tpu_torch.utils import viterbi

    names = sorted({t for ts in tags for t in ts})
    ix = {t: i for i, t in enumerate(names)}
    wv = WordVectors(w2v.cache, w2v.syn0.cpu())
    n_tr = st["tag_train"]
    train = list(zip(seqs[:n_tr], tags[:n_tr]))
    test = list(zip(seqs[n_tr:], tags[n_tr:]))
    it = Word2VecDataSetIterator(wv, train, names, batch_size=256,
                                 window_size=st["tag_window"], device="cuda")
    batches = list(it)
    n_in = batches[0].features.shape[1]
    net = np_softmax_net(n_in, len(names), lr=0.2)
    t0 = time.perf_counter()
    net.fit_backprop(batches, num_epochs=st["tag_epochs"])
    torch.cuda.synchronize()
    fit_ms = (time.perf_counter() - t0) * 1e3
    xt = torch.cat([b.features for b in Word2VecDataSetIterator(
        wv, test, names, batch_size=4096, window_size=st["tag_window"],
        device="cuda")])
    with torch.no_grad():
        probs = net.output(xt)
    em = torch.log(probs.clamp_min(1e-30)).reshape(len(test), st["width"],
                                                    len(names))
    trans = viterbi.transitions_from_labels(
        [[ix[t] for t in ts] for ts in tags[:n_tr]], len(names),
        device="cuda")
    t0 = time.perf_counter()
    paths, logp = viterbi.decode_batch(em, trans)
    torch.cuda.synchronize()
    dec_ms = (time.perf_counter() - t0) * 1e3
    cpu_paths, cpu_logp = viterbi.decode_batch(em.cpu(), trans.cpu())
    same = bool(torch.equal(paths.cpu(), cpu_paths))
    gold = torch.tensor([[ix[t] for t in ts] for ts in tags[n_tr:]])
    acc = float((paths.cpu() == gold).float().mean())
    greedy = float((em.argmax(-1).cpu() == gold).float().mean())
    major = float(torch.bincount(gold.flatten()).max()) / gold.numel()
    say(f"(c) tagging {len(train)} + {len(test)} text8 windows of "
        f"{st['width']} words ({len(names)} tags from default_tagger): "
        f"{n_in} inputs, softmax fit {st['tag_epochs']} epochs {fit_ms:.1f} "
        f"ms; Viterbi over [{len(test)}, {st['width']}, {len(names)}] "
        f"{dec_ms:.2f} ms; paths on the card equal to the CPU's {same}, "
        f"log-probability max|diff| "
        f"{float((logp.cpu() - cpu_logp).abs().max()):.3e}; tag accuracy "
        f"{acc:.4f} (per-position argmax {greedy:.4f}, the majority tag's "
        f"share {major:.4f}) [{card}]")
    check(same, "phase 25 Viterbi: card and CPU paths differ")
    check(acc > major, f"phase 25 tagging: accuracy {acc:.4f} not above the "
                       f"majority tag's share {major:.4f}")


def nlp_phase(torch, fw, t8, card: str) -> int:
    """Phase 25: returns B4's launches on its path.  Four spawned
    workers parse and tag text8 and run the CPU sides of the checks (one
    of them Barnes-Hut on the card) while this process drives the
    card."""
    import multiprocessing

    st = NP_SETTINGS
    t = [time.perf_counter()]
    marks = []

    def mark(name):
        t.append(time.perf_counter())
        marks.append(name)

    def say(line):
        print("  " + line)

    pool = multiprocessing.get_context("spawn").Pool(
        4, initializer=np_worker_init)
    try:
        parse = pool.apply_async(np_parse_job, (st,))
        w2v, launches = np_vectors(torch, fw, t8, st, card, say)
        x = w2v.syn0.detach()
        x_host = x.cpu().numpy()
        words = w2v.cache.words()
        bh_x = x_host[:st["bh_n"]].astype(np.float64)
        bh = {dev: pool.apply_async(np_bh_job, (st, bh_x, dev))
              for dev in ("cuda", "cpu")}
        mark("(b) word2vec")
        np_kmeans(torch, x, st, say, card)
        mark("(b) k-means")
        y20, tsne_cpu = np_tsne(torch, pool, x_host, words, st, say, card)
        mark("(b) t-SNE")
        np_newsgroups(torch, st, say, card)
        mark("(d) newsgroups")
        trees, labels, seqs, tags, parse_s = np_get(parse, "parsing")
        say(f"parsing and tagging in a worker: {parse_s:.1f} s")
        mark("waiting for the parses")
        first, rntn_cpu = np_rntn(torch, pool, trees, labels, st, say, card)
        mark("(a) RNTN")
        np_sequences(torch, w2v, seqs, tags, st, say, card)
        mark("(c) sequences")
        np_rntn_parity(first, rntn_cpu, say)
        y20_cpu, kl20_cpu = np_get(tsne_cpu, "t-SNE on the CPU")
        rel = np_rel(y20, y20_cpu)
        say(f"(b) exact t-SNE, {st['tsne_check_iter']} iterations from the "
            f"same y0, card against the CPU: {rel:.3e} relative (tolerance "
            f"{NP_TSNE_RTOL:g}); CPU KL {kl20_cpu:.6f}")
        check(rel <= NP_TSNE_RTOL, "phase 25 t-SNE: card and CPU differ")
        (yb, sb), (yc, sc) = (np_get(bh[d], f"Barnes-Hut on {d}")
                              for d in ("cuda", "cpu"))
        rel = np_rel(yb, yc)
        say(f"(b) Barnes-Hut t-SNE of the {st['bh_n']} most frequent words "
            f"({st['bh_iter']} iterations, below full width: host SpTree "
            f"forces): card {sb:.1f} s, CPU {sc:.1f} s (each in a worker); "
            f"card against CPU {rel:.3e} relative (tolerance "
            f"{NP_BH_RTOL:g}) [{card}]")
        check(np.isfinite(yb).all() and rel <= NP_BH_RTOL,
              "phase 25 Barnes-Hut: card and CPU differ")
        mark("the workers' checks")
    finally:
        pool.terminate()
        pool.join()
    say("phase 25 wall: " + ", ".join(
        f"{n_} {b_ - a_:.1f} s" for n_, a_, b_ in zip(marks, t, t[1:]))
        + f"; total {t[-1] - t[0]:.1f} s; B4 launches on the path "
          f"{launches}")
    return launches


#: the examples phase 26 runs, the kernels each must launch
EX_KERNELS = {
    "mnist_lenet": (),
    "word_embeddings": ("word2vec_chunk", "glove_chunk"),
    "text_generation": ("flash_attention_fwd", "flash_attention_bwd_dkv",
                        "flash_attention_bwd_dq"),
    "data_parallel": ("flash_attention_fwd", "flash_attention_bwd_dkv",
                      "flash_attention_bwd_dq"),
    "distributed_runtime": (),
    "parallelism_axes": ("flash_attention_fwd", "flash_attention_bwd_dkv",
                         "flash_attention_bwd_dq"),
    "streaming_ingestion": (),
}
#: seconds an example may run in phase 26 (its ranks' own deadline is
#: the spawner's 120 s)
EX_DEADLINE_S = 240.0


def ex_floats(out: str, pattern: str) -> list:
    import re

    return [float(x) for x in re.findall(pattern, out, re.M)]


def ex_check(name: str, out: str) -> dict:
    """Phase 26's checks of one example's output; its launches line's
    counts."""
    import ast

    lines = [ln for ln in out.splitlines()
             if ln.startswith("kernel launches:")]
    check(len(lines) == 1, f"phase 26 {name}: no launches line")
    counts = json.loads(lines[0][len("kernel launches:"):])
    for k in EX_KERNELS[name]:
        check(counts.get(k, 0) > 0, f"phase 26 {name}: {k} never launched "
                                    f"({counts})")
    if name == "mnist_lenet":
        acc = ex_floats(out, r"^ Accuracy:\s+([0-9.]+)$")
        check(len(acc) == 1 and acc[0] >= 0.90,
              f"phase 26 mnist_lenet: test accuracy {acc} < 0.90")
    elif name == "word_embeddings":
        from deeplearning4j_tpu_torch.examples.word_embeddings import CORPUS

        vocab = {w for sentence in CORPUS for w in sentence.split()}
        for prefix in ("word2vec nearest(sea):",
                       "word2vec[device] nearest(sea):"):
            line = [ln for ln in out.splitlines() if ln.startswith(prefix)]
            near = ast.literal_eval(line[0][len(prefix):].strip()) \
                if line else []
            check(len(near) == 3 and all(w in vocab for w, _ in near),
                  f"phase 26 word_embeddings: {prefix} {near}")
        sims = ex_floats(out, r"sim\(cat,\w+\) = (\S+)")
        check(len(sims) == 2 and all(map(math.isfinite, sims)),
              f"phase 26 word_embeddings: GloVe similarities {sims}")
    elif name == "text_generation":
        first = ex_floats(out, r"^first LM loss: (\S+)$")
        final = ex_floats(out, r"^final LM loss: (\S+)$")
        check(len(first) == len(final) == 1 and math.isfinite(final[0])
              and final[0] < first[0],
              f"phase 26 text_generation: losses {first} -> {final}")
        check("gpt continuation: 'the quick " in out,
              "phase 26 text_generation: no continuation")
    elif name == "data_parallel":
        losses = ex_floats(out, r"^step \d: loss (\S+)  \(batch sharded")
        check(len(losses) == 5 and all(map(math.isfinite, losses))
              and losses[-1] < losses[0],
              f"phase 26 data_parallel: losses {losses}")
    elif name == "distributed_runtime":
        check("with 25% injected crashes: identical result -> True" in out,
              "phase 26 distributed_runtime: the chaotic counts differ")
    elif name == "parallelism_axes":
        losses = ex_floats(out, r"(?:BERT|MoE-LM) loss (\S+)$")
        check(len(losses) == 4 and all(map(math.isfinite, losses))
              and "all parallelism axes OK" in out,
              f"phase 26 parallelism_axes: losses {losses}")
    elif name == "streaming_ingestion":
        accs = ex_floats(out, r"accuracy ([0-9.]+)$")
        check(len(accs) == 2 and min(accs) >= 0.85,
              f"phase 26 streaming_ingestion: accuracies {accs}")
    return counts


def examples_phase(card: str) -> dict:
    """Phase 26: the seven examples, each a subprocess as a user runs
    it, all at once; the B1-B5 launches they report, summed."""
    import tempfile

    # one CPU thread a process: fifteen processes (the eight ranks among
    # them) share the host's cores
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_examples_")
    t0 = time.perf_counter()
    runs = {}
    try:
        for name in EX_KERNELS:
            out = open(os.path.join(tmp, f"{name}.out"), "w+")
            err = open(os.path.join(tmp, f"{name}.err"), "w+")
            proc = subprocess.Popen(
                [sys.executable, "-m",
                 f"deeplearning4j_tpu_torch.examples.{name}"],
                cwd=REPO, env=env, stdout=out, stderr=err)
            runs[name] = (proc, out, err)
        ends = {}
        deadline = t0 + EX_DEADLINE_S
        while len(ends) < len(runs) and time.perf_counter() < deadline:
            for name, (proc, _, _) in runs.items():
                if name not in ends and proc.poll() is not None:
                    ends[name] = time.perf_counter() - t0
            time.sleep(0.1)
        late = [n for n in runs if n not in ends]
        for proc, _, _ in runs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(10)
        check(not late, f"phase 26: {late} still running after "
                        f"{EX_DEADLINE_S:g} s: killed")
        total = {}
        for name, (proc, out, err) in runs.items():
            out.seek(0)
            err.seek(0)
            text, errs = out.read(), err.read()
            check(proc.returncode == 0,
                  f"phase 26 {name}: exit code {proc.returncode}\n"
                  f"{text[-3000:]}\n{errs[-3000:]}")
            counts = ex_check(name, text)
            shown = [ln for ln in text.splitlines()
                     if not ln.startswith(("kernel launches:", " [", "[["))]
            print(f"  {name}: {ends[name]:.1f} s wall [{card}]")
            for ln in shown[-6:]:
                print(f"    {ln[:200]}")
            print(f"    launches {counts}")
            for k, n in counts.items():
                total[k] = total.get(k, 0) + n
    finally:
        for _, out, err in runs.values():
            out.close()
            err.close()
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"  phase 26: the seven examples side by side in "
          f"{time.perf_counter() - t0:.1f} s; launches {total} [{card}]")
    return total


class PhaseClock:
    """Each phase's header when it starts and, when the next one starts
    (or :meth:`stop`), a line naming the phase with its seconds; the
    summary lists them all with the whole script's."""

    def __init__(self):
        self.t_start = time.perf_counter()
        self.name = None
        self.t0 = 0.0
        self.rows = []

    def start(self, name: str, title: str) -> None:
        self.stop()
        print(f"phase {name}: {title}")
        self.name, self.t0 = name, time.perf_counter()

    def stop(self) -> None:
        if self.name is not None:
            secs = time.perf_counter() - self.t0
            self.rows.append((self.name, secs))
            print(f"phase {self.name}: {secs:.1f} s")
            self.name = None

    def summary(self) -> None:
        self.stop()
        print("phase seconds: " + ", ".join(
            f"{n} {s:.1f}" for n, s in self.rows)
            + f"; script {time.perf_counter() - self.t_start:.1f} s")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch import resolve_device
    from deeplearning4j_tpu_torch.ops import cuda_build
    from deeplearning4j_tpu_torch.ops import flash_attention as fa

    resolve_device("cuda")         # fp32 products in full fp32 (no TF32)
    # no autotune winner may route phases 1-17 (phase 18 sweeps into a
    # temporary cache of its own)
    from deeplearning4j_tpu_torch.runtime import autotune
    os.environ[autotune.AUTOTUNE_CACHE_ENV] = "off"

    clock = PhaseClock()
    clock.start("1", "environment")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, device "
          f"{torch.cuda.get_device_name(0)}")

    clock.start("2", "build")
    t0 = time.perf_counter()
    seconds = cuda_build.build()
    print(f"  built {sorted(seconds)} in {time.perf_counter() - t0:.1f} s")
    for name in seconds:
        log = cuda_build.library_path(name).with_name(
            cuda_build.library_path(name).name + ".log")
        for kernel, line, spilled in ptxas_summary(log.read_text()):
            print(f"  ptxas {name}: {line}")
            check(spilled == 0 or "wgmma" not in kernel,
                  f"{kernel} spills {spilled} bytes")
    for D in (64, 128):
        dkv, dq = fa.bwd_wgmma_smem(D)
        print(f"  wgmma B1 at D={D}: {fa.fwd_wgmma_smem(D)} bytes of dynamic "
              f"shared memory a CTA")
        print(f"  wgmma B2/B3 at D={D}: {dkv} / {dq} bytes of dynamic "
              f"shared memory a CTA")

    clock.start("3", "kernels against their plain twins")
    worst = kernel_phase(torch, fa)
    time_flash(torch, F, fa, B=1, T=128)      # serving's smallest bucket
    time_flash(torch, F, fa, B=32, T=128)
    ms, plain_ms, lib_ms, bound_ms, bound_by = time_flash(
        torch, F, fa, B=32, T=512)
    time_flash(torch, F, fa, B=8, T=1024, causal=True)   # GPT-2 small's
    worst_bwd = kernel_bwd_phase(torch, fa)
    bwd_rows = time_flash_bwd(torch, F, fa, B=32, T=128)
    time_flash_bwd(torch, F, fa, B=8, T=512)
    time_flash_bwd(torch, F, fa, B=8, T=1024, causal=True)

    clock.start("3c", "B4 (word2vec chunk) and B5 (GloVe chunk) against "
                "their plain twins")
    from deeplearning4j_tpu_torch.nlp.glove import count_cooccurrences
    from deeplearning4j_tpu_torch.nlp.text import DefaultTokenizerFactory
    from deeplearning4j_tpu_torch.nlp.vocab import build_huffman, build_vocab
    from deeplearning4j_tpu_torch.nlp.word2vec import (corpus_pairs,
                                                       prepare_train_tables)
    from deeplearning4j_tpu_torch.ops import fused_glove as fg
    from deeplearning4j_tpu_torch.ops import fused_word2vec as fw

    t0 = time.perf_counter()
    tok = DefaultTokenizerFactory()
    t8 = text8_sentences()
    cache5 = build_vocab(t8, tok, 5)
    build_huffman(cache5)
    t8_tables = prepare_train_tables(cache5, 100_000)
    t8_idx = [np.asarray([cache5.index_of(w) for w in tok(s)
                          if w in cache5], np.int32) for s in t8]
    t8_pairs = corpus_pairs([a for a in t8_idx if a.size], 5)[:2]
    cache1 = build_vocab(t8, tok, 1)
    t8_triples = count_cooccurrences(t8, tok, cache1) + (len(cache1),)
    zipf_vocab = zipf_cache()
    zipf_sents = zipf_sentences()
    print(f"  corpora: text8 {len(t8)} sentences, V={len(cache5)} at min "
          f"count 5, Huffman depth {t8_tables[0].shape[1]}; Zipf "
          f"{len(zipf_sents)} sentences of 30 words; set-up "
          f"{time.perf_counter() - t0:.1f} s")
    worst_w2v, w2v_rows = w2v_kernel_phase(
        torch, fw, w2v_case_chunks(torch, t8_tables, t8_pairs, zipf_vocab))
    worst_glove, glove_rows = glove_kernel_phase(
        torch, fg, glove_case_chunks(torch, t8_triples, zipf_vocab[1]))

    # each main path runs with the counts set to 0 just before it and
    # read just after; the line below sums them
    clock.start("4", "BERT-base fill-mask serving")
    launches = {"launches": serving_phase(torch, fa), "launches_dkv": 0,
                "launches_dq": 0}
    clock.start("5", "BERT-base MLM training")
    for name, n in bert_train_phase(torch, fa).items():
        launches[name] += n
    clock.start("6", "GPT-2 small causal-LM training")
    for name, n in gpt_train_phase(torch, fa).items():
        launches[name] += n
    clock.start("7", "word2vec and ParagraphVectors training")
    launches_w2v = word2vec_phase(torch, fw, t8, zipf_sents)
    clock.start("8", "GloVe training")
    launches_glove = glove_phase(torch, fg, t8, zipf_sents)
    clock.start("9", "LeNet-MNIST training, evaluation and serving")
    from deeplearning4j_tpu_torch.models import lenet as ln

    for mod in (fa, fw, fg):
        mod.reset_launches()
    lenet_phase(torch, ln, card)
    hand = {**fa.launch_counts(), "w2v": fw.launches, "glove": fg.launches}
    print(f"  hand-kernel launches during phase 9: {hand} (no TPU kernel "
          f"lies on LeNet's path)")
    check(not any(hand.values()), f"a hand kernel ran on LeNet's path: "
                                  f"{hand}")
    clock.start("10", "GPT-2 small generation serving")
    launches["launches"] += generation_phase(torch, fa, card)
    clock.start("11", "the compile engine's CUDA graphs against the raw "
                "functions")
    graph_phase(torch, ln, t8, card)
    clock.start("12", "self-healing training, checkpoints and run telemetry")
    for name, n in resilience_phase(torch, fa, ln, card).items():
        launches[name] += n
    clock.start("13", "fit, the solvers, greedy pretraining, Hessian-free and "
                "the CLI")
    for mod in (fa, fw, fg):
        mod.reset_launches()
    fit_phase(torch, ln, card)
    hand = {**fa.launch_counts(), "w2v": fw.launches, "glove": fg.launches}
    print(f"  hand-kernel launches during phase 13: {hand} (no TPU kernel "
          f"lies on fit's path)")
    check(not any(hand.values()), f"a hand kernel ran during phase 13: "
                                  f"{hand}")
    clock.start("14", "GPT-2 small serving at scale: paged KV, the prefix "
                "store, speculative decoding, rebind, the router, cli "
                "generate")
    for name, n in serving_scale_phase(torch, fa, fw, fg, card).items():
        launches[name] += n
    clock.start("15", "the GPT-2 small serving fleet: autoscaling, the hot "
                "weight swap, the chaos drill, the brownout ladder, close")
    fleet_phase(torch, fa, fw, fg, card)
    clock.start("16", "ResNet-50 training and serving; the MoE LM at GPT-2 "
                "small's widths")
    for name, n in resnet_moe_phase(torch, fa, fw, fg, card).items():
        launches[name] += n
    clock.start("17", "the sharded-fit spine: CausalLM, bf16 with the loss "
                "scale, accumulation, a data mesh of one, the MoE LM, the "
                "MultiLayerNetwork bundle, ResilientFit")
    for name, n in spine_phase(torch, fa, card).items():
        launches[name] += n
    clock.start("18", "the rest of the MultiLayerNetwork surface: the "
                "char-LSTM through LSTMSequenceClassifier, LFW through the "
                "native JPEG path, the recursive autoencoder, GraphBuilder, "
                "the attention autotuner")
    slice_phase(torch, fa, fw, fg, card)
    clock.start("19", "the model axis: tensor-parallel GPT-2 small "
                "training through CausalLM, the head-sharded DecodeEngine "
                "and BERT-base's make_train_step on two gloo ranks sharing "
                "the card")
    counts, worst_19, worst_bwd_19 = model_axis_phase(torch, fa, card)
    for name, n in counts.items():
        launches[name] += n
    worst = max(worst, worst_19)
    worst_bwd = {k: max(v, worst_bwd_19[k]) for k, v in worst_bwd.items()}
    clock.start("20", "the model axis for a serving fleet and the expert "
                "axis: GPT-2 small served over a model group through "
                "Router.replicate and with int8 weights, int8 KV and a "
                "draft; the MoE LM expert-parallel through "
                "moe.make_train_step and CausalLM, and on a model axis; two "
                "gloo ranks sharing the card")
    for name, n in expert_axis_phase(torch, fa, card).items():
        launches[name] += n
    clock.start("21", "the pipe and seq axes: the ring shift, ring and "
                "Ulysses attention over B1-B3, GPT-2 small through CausalLM "
                "on data=1 x pipe=2 and data=1 x seq=2, BERT-base's "
                "pipeline and sequence-parallel steps; two gloo ranks "
                "sharing the card")
    for name, n in pipe_seq_phase(torch, fa, card).items():
        launches[name] += n
    clock.start("22", "sharded snapshots, the cluster control plane and "
                "recovery: GPT-2 small through CausalLM under "
                "ResilientFit(cluster=) on gloo ranks sharing the card; a "
                "sharded snapshot, an elastic re-mesh, a real host loss, a "
                "preemption across the cluster")
    for name, n in recovery_phase(torch, fa, card).items():
        launches[name] += n
    clock.start("23", "the data-parallel input and training paths: GPT-2 "
                "small through ResilientFit over the DataService, "
                "ResNet-50 on a data mesh, word2vec and GloVe on a data "
                "mesh through B4/B5; gloo ranks sharing the card and NCCL "
                "meshes of one")
    dp = dp_phase(torch, fa, fw, fg, card)
    for name in ("launches", "launches_dkv", "launches_dq"):
        launches[name] += dp[name]
    launches_w2v += dp["w2v"]
    launches_glove += dp["glove"]
    clock.start("24", "the scale-out runtime: GPT-2 small served on "
                "data=1 x pipe=2 and data=1 x seq=2 by two gloo ranks, "
                "distributed word2vec and GloVe through B4/B5, the "
                "multi-process runner with a SIGKILLed worker, Hogwild and "
                "the chaos performer")
    sc = scaleout_phase(torch, fa, fw, fg, ln, t8, card)
    launches["launches"] += sc["launches"]
    launches_w2v += sc["w2v"]
    launches_glove += sc["glove"]
    clock.start("25", "NLP and periphery: RNTN sentiment from raw text8 "
                "windows, word2vec vectors through B4 into k-means, exact "
                "and Barnes-Hut t-SNE and the embedding page, moving-window "
                "tagging decoded by Viterbi, TF-IDF newsgroups")
    launches_w2v += nlp_phase(torch, fw, t8, card)
    clock.start("26", "the examples: the seven user entry points under "
                "deeplearning4j_tpu_torch/examples as subprocesses, all at "
                "once (parallelism_axes on 8 gloo ranks sharing the card)")
    ex = examples_phase(card)
    launches["launches"] += ex["flash_attention_fwd"]
    launches["launches_dkv"] += ex["flash_attention_bwd_dkv"]
    launches["launches_dq"] += ex["flash_attention_bwd_dq"]
    launches_w2v += ex["word2vec_chunk"]
    launches_glove += ex["glove_chunk"]
    clock.stop()

    kernels = [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "deeplearning4j_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "deeplearning4j_tpu/ops/pallas_attention.py:83",
        "launches": launches["launches"],
        "max_abs_err": worst,
        "ms": ms,
        "kernel_ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": lib_ms,
    }]
    for kernel, name, line, counter in (
            ("dkv", "flash_attention_bwd_dkv", 188, "launches_dkv"),
            ("dq", "flash_attention_bwd_dq", 240, "launches_dq")):
        k_ms, k_plain, k_lib, k_bound, k_by = bwd_rows[kernel]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "deeplearning4j_tpu_torch/csrc/flash_bwd.cu",
            "replaces": f"deeplearning4j_tpu/ops/pallas_attention.py:{line}",
            "launches": launches[counter],
            "max_abs_err": worst_bwd[kernel],
            "ms": k_ms,
            "kernel_ms": k_ms,
            "plain_ms": k_plain,
            "bound_ms": k_bound,
            "bound_by": k_by,
            "library_ms": k_lib,
        })
    # B4 and B5 at the text8 main-path shape (the first timed case): the
    # device time summed over every phase of one call (B5: one chunk
    # step); no single PyTorch call computes either function, so no
    # library time
    for name, source, replaces, n, worst_err, rows, extra in (
            ("word2vec_chunk", "word2vec_chunk.cu",
             "deeplearning4j_tpu/ops/pallas_word2vec.py:91", launches_w2v,
             worst_w2v, w2v_rows, "call_ms"),
            ("glove_chunk", "glove_chunk.cu",
             "deeplearning4j_tpu/ops/pallas_glove.py:64", launches_glove,
             worst_glove, glove_rows, "old_composition_ms")):
        _, k_ms, k_plain, k_bound, k_by, k_extra = rows[0]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"deeplearning4j_tpu_torch/csrc/{source}",
            "replaces": replaces,
            "launches": n,
            "max_abs_err": worst_err,
            "ms": k_ms,
            "kernel_ms": k_ms,
            extra: k_extra,
            "plain_ms": k_plain,
            "bound_ms": k_bound,
            "bound_by": k_by,
            "library_ms": None,
        })
    check(launches_w2v > 0 and launches_glove > 0,
          "B4 or B5 never launched on the main paths")
    clock.summary()
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
