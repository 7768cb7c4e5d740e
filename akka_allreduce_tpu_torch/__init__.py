"""akka_allreduce_tpu_torch — the PyTorch/CUDA port of ``akka_allreduce_tpu``.

A second package beside the JAX one, written for one NVIDIA Hopper card
(H100, ``sm_90a``). Every kernel the JAX package wrote in Pallas for the TPU
is a kernel written by hand here (CUDA C++ under ``ops/csrc``); plain tensor
code is PyTorch. The package imports ``torch`` and never ``jax`` nor anything
of ``akka_allreduce_tpu``: what it shares with the JAX package (configs,
timing helpers) it keeps as its own copy.

Module names mirror the JAX package so each counterpart is easy to find:

- ``config``        — every config of the JAX package (``ThresholdConfig``,
  ``MetaDataConfig``, ``WorkerConfig``, ..., ``AllreduceConfig`` with its
  JSON form)
- ``protocol``, ``buffers``, ``control``, ``tensor_reduce`` — the host
  engine, BASELINE config 1: the round messages, the per-round buffers
  (sums and output as tensors on the card, counts and flags on the host),
  ``AllreduceWorker``, ``LineMaster``, ``GridMaster``, ``AllreduceNode`` and
  ``LocalAllreduceSystem`` over an in-process router, and the four
  reductions of the JAX package's ``native/`` as tensor ops; the TCP
  control plane (``control/remote.py``, ``control/bootstrap.py``'s
  ``MasterProcess`` and ``NodeProcess``, membership, gossip, failure
  detection, the full wire codec and peer chunk transfer)
- ``native``        — the wire codec's C++ hot loop (``wire.cpp``: frame
  headers, checksums, ``sendmmsg``, io_uring), built by g++ at first use
- ``obs``           — metrics registry, spans, flight recorder, round
  watchdog (stdlib copies)
- ``parallel``      — meshes of n virtual ranks on one device
  (``line_mesh``, ``grid_mesh``, ``data_seq_mesh``)
- ``comm``          — the threshold allreduce over those ranks (psum,
  butterfly, ring and the ring kernel; bf16/int8 wire compression) and the
  bus-bandwidth harness
- ``ops``           — the hand-written kernels and their plain versions:
  the single-card threshold reduce (``masked_average``,
  ``elastic_average_step``), the ring allreduce
  (``ring_kernel_allreduce_sum``) and flash attention, forward and
  backward behind one ``torch.autograd.Function`` (``flash_attention``),
  with the attention dispatch (``local_attention``: dense, flash or
  blockwise)
- ``models``        — the Transformer LM (``TransformerLM``, ``rope``,
  ``remat``; over virtual ranks with ``seq_axis``/``model_axis``,
  ``tp_param_specs``), its KV-cache decoder (``LMGenerator``), the MLP of
  config 3 (``MLP``), ResNet-50 of config 4 (``ResNet50``), the copy task's
  and the classification streams' data (host batches and device samplers),
  ``.npz`` files (``FileDataset``) and the carrying-over of flax weights
- ``train``         — ``DPTrainer``, the data-parallel trainer over virtual
  ranks (its f32 gradient average through K1 on the card, fused or one
  sync a parameter leaf inside the backward; gradient accumulation),
  ``LongContextTrainer``, the LM's trainer over a (data, seq[, model])
  mesh of virtual ranks, and the shared helpers
- ``binder``        — parameters to and from one flat f32 vector in the JAX
  trainers' leaf order (``flatten_params``), the ``AllreduceBinder``
  protocol and the host engine's ``GradSyncBinder`` and
  ``ElasticAverageBinder``
- ``state``         — hand-over of the ``(K, data)`` replica state to and from
  numpy, in the JAX package's flat or packed layout
- ``utils``         — slope timing, CUDA-event timing, card description,
  FLOP accounting, per-round metrics, replica checks over virtual ranks
- ``bench_suite``   — BASELINE config 1 (the host engine), the single-card
  branch of configs 2 and 4, and config 3
- ``__main__``      — ``bench-suite``, ``local-demo`` (the host engine),
  ``cluster-master``, ``cluster-node``, ``cluster-standby``, ``bench-wire``
  and ``obs`` (the TCP control plane, in ``cluster_cli``),
  ``bench`` (allreduce bandwidth),
  ``lm-generate`` (KV-cache decoding, optionally after training),
  ``train-lm``, ``train-mlp``, ``train-resnet`` and ``bench-mfu``
- ``graft_entry``   — ``entry()`` (the ResNet-50 forward) and
  ``dryrun_multichip(n)`` (DP steps and the schedules over n virtual ranks)
- ``bench``         — the single-card ``local_threshold_reduce_bw`` metric
- ``bench_mfu``     — the slope-timed MFU of the LM's, the MLP's and
  ResNet-50's training steps

Entry points run on the card unless the caller passes ``device="cpu"``; with
no CUDA they raise instead of running on the CPU (see ``_device``).
"""

__version__ = "0.1.0"
