"""Unified default configuration tree.

The reference maintains two parallel yacs trees — ``cfg`` for the Uni-Prompt
pipeline (reference ``config/defaults.py:13-351``) and ``cfg_base`` for the
baseline (``config/defaults_base.py:13-188``). Here a single tree covers both:
the baseline's flat ``SOLVER.*`` fields and the Uni-Prompt per-stage
``SOLVER.STAGE1/1A/1B/2`` blocks coexist, so every reference YAML overlay
(configs/person, configs/ours, configs/veri, configs/VehicleID) merges cleanly.

TPU-specific additions live under ``TPU.*`` (mesh shape, dtype policy, input
pipeline knobs) and default to sensible single-chip values.

A copy kept in the port (ref mpreid_tpu/config/defaults.py::get_default_cfg), so the
port imports nothing of the JAX package.
"""

from .node import CfgNode as CN


def _stage_solver() -> CN:
    """One per-stage solver block (reference defaults.py:120-268)."""
    s = CN()
    s.IMS_PER_BATCH = 64
    s.OPTIMIZER_NAME = "Adam"
    s.MAX_EPOCHS = 100
    s.BASE_LR = 3e-4
    s.MOMENTUM = 0.9
    s.WEIGHT_DECAY = 0.0005
    s.WEIGHT_DECAY_BIAS = 0.0005
    s.WARMUP_FACTOR = 0.01
    s.WARMUP_EPOCHS = 5
    s.WARMUP_LR_INIT = 0.01
    s.LR_MIN = 0.000016
    s.WARMUP_ITERS = 500
    s.WARMUP_METHOD = "linear"
    s.COSINE_MARGIN = 0.5
    s.COSINE_SCALE = 30
    s.CHECKPOINT_PERIOD = 10
    s.LOG_PERIOD = 100
    s.EVAL_PERIOD = 10
    # stage-2-only extras (harmless in stage-1 blocks)
    s.LARGE_FC_LR = False
    s.BIAS_LR_FACTOR = 1
    s.CENTER_LR = 0.5
    s.CENTER_LOSS_WEIGHT = 0.0005
    s.GAMMA = 0.1
    s.STEPS = (40, 70)
    # Adam/SGD moment storage dtype: "float32" (torch-exact) or "bfloat16"
    # (the Adam update is bound by memory traffic, and bf16 moments move
    # 20 instead of 28 bytes per element; moment math still accumulates
    # fp32, see solver/optim.py)
    s.MOMENT_DTYPE = "float32"
    # Fused Adam/AdamW update (ops/adam.py, the CUDA kernel
    # kernels/csrc/adam.cu) for CUDA leaves of at least
    # ops.adam.MIN_FUSED_SIZE elements; off: the plain per-leaf update.
    # Times on the card: PERF.md.
    s.FUSED_ADAM = False
    return s


def get_default_cfg() -> CN:
    _C = CN()

    # ------------------------------------------------------------------ MODEL
    _C.MODEL = CN()
    _C.MODEL.DEVICE = "tpu"
    _C.MODEL.DEVICE_ID = "0"
    _C.MODEL.NAME = "resnet50"
    _C.MODEL.LAST_STRIDE = 1
    _C.MODEL.PRETRAIN_PATH = ""
    _C.MODEL.PRETRAIN_CHOICE = "imagenet"
    # with no PRETRAIN_PATH, download the OpenAI CLIP checkpoint for
    # MODEL.NAME (SHA256-verified, ~/.cache/clip) like the reference always
    # does (ref model/clip/clip.py:39-68). Off by default so egress-free
    # hosts and unit tests can build randomly-initialized models.
    _C.MODEL.PRETRAIN_AUTO = False
    _C.MODEL.NECK = "bnneck"
    _C.MODEL.IF_WITH_CENTER = "no"
    _C.MODEL.ID_LOSS_TYPE = "softmax"
    _C.MODEL.ID_LOSS_WEIGHT = 1.0
    _C.MODEL.TRIPLET_LOSS_WEIGHT = 1.0
    _C.MODEL.I2T_LOSS_WEIGHT = 1.0
    _C.MODEL.METRIC_LOSS_TYPE = "triplet"
    _C.MODEL.DIST_TRAIN = False
    _C.MODEL.NO_MARGIN = False
    _C.MODEL.IF_LABELSMOOTH = "on"
    _C.MODEL.COS_LAYER = False
    # margin head used when COS_LAYER is on (the reference stores the flag at
    # make_model.py:34 but never consumes it; here it is wired)
    _C.MODEL.COS_LAYER_TYPE = "arcface"
    _C.MODEL.DROP_PATH = 0.1
    _C.MODEL.DROP_OUT = 0.0
    _C.MODEL.ATT_DROP_RATE = 0.0
    _C.MODEL.TRANSFORMER_TYPE = "None"
    _C.MODEL.STRIDE_SIZE = [16, 16]
    # Shrink the CLIP towers to a 2-layer/64-wide debug model (CLI smoke runs)
    _C.MODEL.DEBUG_TINY = False
    # How the JAX package stores each tower's in_proj columns ("" → its
    # default "hm_native", head-major; "packed" | "hm" keep torch [q|k|v]):
    # models/convert.py reads JAX weights with it. The port itself always
    # stores and computes the torch packing (models/clip_model.py).
    _C.MODEL.ATTN_LAYOUT_VISION = ""
    _C.MODEL.ATTN_LAYOUT_TEXT = ""

    # SIE (side-information embedding)
    _C.MODEL.SIE_COE = 3.0
    _C.MODEL.SIE_CAMERA = False
    _C.MODEL.SIE_VIEW = False
    # MoE (reference defaults.py:66-73)
    _C.MODEL.MOE = CN()
    _C.MODEL.MOE.ENABLED = False
    _C.MODEL.MOE.NUM_EXPERTS = 0
    _C.MODEL.MOE.TOP_K = 0
    _C.MODEL.MOE.MOE_LAYERS = 0
    _C.MODEL.MOE.DROPOUT = 0.0
    _C.MODEL.MOE.FREEZE_EXCEPT_GATE = False
    _C.MODEL.MOE.MODEL_PATH_LIST = []
    # Shared first-block routing decision (reference clip/model.py:304-330)
    _C.MODEL.MOE.SHARED_ROUTING = True
    _C.MODEL.MOE.AUX_LOSS_COEFF = 0.01

    # ------------------------------------------------------------------ INPUT
    _C.INPUT = CN()
    _C.INPUT.SIZE_TRAIN = [384, 128]
    _C.INPUT.SIZE_TEST = [384, 128]
    _C.INPUT.PROB = 0.5         # horizontal-flip probability
    _C.INPUT.RE_PROB = 0.5      # random-erasing probability
    _C.INPUT.PIXEL_MEAN = [0.485, 0.456, 0.406]
    _C.INPUT.PIXEL_STD = [0.229, 0.224, 0.225]
    _C.INPUT.PADDING = 10

    # --------------------------------------------------------------- DATASETS
    _C.DATASETS = CN()
    _C.DATASETS.NAMES = "market1501"
    _C.DATASETS.ROOT_DIR = "../data"
    _C.DATASETS.EXP_SETTING = "cctv_ir_cctv_rgb"

    # ------------------------------------------------------------- DATALOADER
    _C.DATALOADER = CN()
    _C.DATALOADER.NUM_WORKERS = 8
    _C.DATALOADER.SAMPLER = "softmax"
    _C.DATALOADER.NUM_INSTANCE = 16
    # Keep decoded uint8 images in RAM after first epoch (small datasets)
    _C.DATALOADER.CACHE_IMAGES = False
    # batch decode+resize in native C++ (libjpeg/libpng + PIL-exact bicubic,
    # mpreid_tpu_torch/native/imageio.cpp). 'auto' uses it when it builds and its
    # byte-parity self-check against PIL passes; True forces (with a warning
    # fallback), False keeps the threaded-PIL path.
    _C.DATALOADER.NATIVE_DECODE = "auto"

    # ----------------------------------------------------------------- SOLVER
    _C.SOLVER = CN()
    _C.SOLVER.SEED = 1234
    _C.SOLVER.MARGIN = 0.3
    # Checkpoint directory to resume a baseline run from (epoch + optimizer
    # state restored) — capability the reference lacks (save-only ckpts).
    _C.SOLVER.RESUME = ""

    # Baseline (flat) solver fields — reference defaults_base.py:107-162
    _C.SOLVER.OPTIMIZER_NAME = "Adam"
    _C.SOLVER.MAX_EPOCHS = 100
    _C.SOLVER.BASE_LR = 3e-4
    _C.SOLVER.LARGE_FC_LR = False
    _C.SOLVER.BIAS_LR_FACTOR = 1
    _C.SOLVER.MOMENTUM = 0.9
    _C.SOLVER.CENTER_LR = 0.5
    _C.SOLVER.CENTER_LOSS_WEIGHT = 0.0005
    _C.SOLVER.WEIGHT_DECAY = 0.0005
    _C.SOLVER.WEIGHT_DECAY_BIAS = 0.0005
    _C.SOLVER.GAMMA = 0.1
    _C.SOLVER.STEPS = (40, 70)
    _C.SOLVER.WARMUP_FACTOR = 0.01
    _C.SOLVER.WARMUP_EPOCHS = 5
    _C.SOLVER.WARMUP_LR_INIT = 0.01
    _C.SOLVER.LR_MIN = 0.000016
    _C.SOLVER.WARMUP_ITERS = 500
    _C.SOLVER.WARMUP_METHOD = "linear"
    _C.SOLVER.COSINE_MARGIN = 0.5
    _C.SOLVER.COSINE_SCALE = 30
    _C.SOLVER.CHECKPOINT_PERIOD = 10
    _C.SOLVER.LOG_PERIOD = 100
    _C.SOLVER.EVAL_PERIOD = 10
    _C.SOLVER.IMS_PER_BATCH = 64
    # Moment storage dtype (see _stage_solver.MOMENT_DTYPE)
    _C.SOLVER.MOMENT_DTYPE = "float32"
    # Fused Adam update kernel (see _stage_solver.FUSED_ADAM; off by default)
    _C.SOLVER.FUSED_ADAM = False
    # Per-stage blocks (Uni-Prompt pipeline)
    _C.SOLVER.STAGE1 = _stage_solver()
    _C.SOLVER.STAGE1A = _stage_solver()
    _C.SOLVER.STAGE1B = _stage_solver()
    _C.SOLVER.STAGE2 = _stage_solver()
    # LoRA block (reference defaults.py:274-308; wired, unlike the reference)
    _C.SOLVER.LORA = CN()
    _C.SOLVER.LORA.ENABLED = False
    _C.SOLVER.LORA.LORA_R = 8
    _C.SOLVER.LORA.LORA_ALPHA = 16
    _C.SOLVER.LORA.LORA_DROPOUT = 0.1
    _C.SOLVER.LORA.IMS_PER_BATCH = 64
    _C.SOLVER.LORA.OPTIMIZER_NAME = "Adam"
    _C.SOLVER.LORA.BASE_LR = 0.00001
    _C.SOLVER.LORA.WARMUP_LR_INIT = 0.000001
    _C.SOLVER.LORA.LR_MIN = 0.000001
    _C.SOLVER.LORA.WARMUP_METHOD = "linear"
    _C.SOLVER.LORA.WEIGHT_DECAY = 0.0001
    _C.SOLVER.LORA.WEIGHT_DECAY_BIAS = 0.0001
    _C.SOLVER.LORA.MAX_EPOCHS = 30
    _C.SOLVER.LORA.WARMUP_EPOCHS = 5
    _C.SOLVER.LORA.CHECKPOINT_PERIOD = 30
    _C.SOLVER.LORA.LOG_PERIOD = 50
    _C.SOLVER.LORA.EVAL_PERIOD = 5

    # ------------------------------------------------------------------- TEST
    _C.TEST = CN()
    _C.TEST.IMS_PER_BATCH = 128
    _C.TEST.RE_RANKING = False
    # quantized Jaccard min-sum (bf16 0/1 matrix products) in the dense
    # re-ranking (ops/reranking.py)
    _C.TEST.RERANK_FAST = False
    # Corpus size (Q+G) above which re-ranking switches to the sparse-V
    # path (ops/reranking_sparse.py): the dense path holds several N² fp32
    # matrices; the sparse path holds O(N·W) and scales to MSMT17-size
    # galleries.
    _C.TEST.RERANK_SPARSE_N = 25000
    _C.TEST.WEIGHT = ""
    _C.TEST.NECK_FEAT = "after"
    _C.TEST.FEAT_NORM = "yes"
    # 'euclidean' (reference behavior) or 'cosine' (arccos distance — the
    # reference ships cosine_similarity but never calls it, metrics.py:15-25)
    _C.TEST.DIST_METRIC = "euclidean"
    _C.TEST.DIST_MAT = "dist_mat.npy"
    _C.TEST.EVAL = False
    # Standard-protocol camera filtering. The reference hard-disables the
    # same-pid+same-cam junk filter (utils/metrics.py:53-56); keep that as the
    # parity default but expose the standard protocol behind this flag.
    _C.TEST.CAMERA_FILTER = False
    _C.TEST.TTA_ENABLED = False
    _C.TEST.TTPT = CN()
    _C.TEST.TTPT.ENABLED = False
    _C.TEST.TTPT.LR = 0.001
    _C.TEST.TTPT.STEPS = 5
    _C.TEST.TTPT.TEMPERATURE = 0.07

    # -------------------------------------------------------------------- TPU
    _C.TPU = CN()
    # Mesh axis sizes; -1 means "all available devices" on that axis.
    _C.TPU.MESH_DATA = -1      # batch / gallery sharding axis
    _C.TPU.MESH_MODEL = 1      # tensor/expert sharding axis
    # Megatron-style tensor parallelism over the transformer towers
    # themselves (QKV/MLP-in column-parallel, out-proj/MLP-out row-parallel
    # over 'model' — parallel/mesh.py::param_spec). For towers too big to
    # replicate; ViT-B/16 fits per chip, so it defaults off.
    _C.TPU.TP_TOWERS = False
    _C.TPU.COMPUTE_DTYPE = "bfloat16"
    _C.TPU.PARAM_DTYPE = "float32"
    # Host-side image decode workers feeding the device pipeline.
    _C.TPU.PREFETCH = 2
    # Remat (activation checkpointing) for the vision transformer blocks.
    _C.TPU.REMAT = False
    # When set, a jax.profiler trace of PROFILE_STEPS early steps of the
    # first epoch is written here (view with tensorboard/xprof).
    _C.TPU.PROFILE_DIR = ""
    _C.TPU.PROFILE_STEPS = 5
    # Shard the eval gallery over the mesh 'data' axis (multi-chip eval;
    # the full QxG distmat never materializes on one device)
    _C.TPU.EVAL_SHARDED = False
    # Persistent XLA compilation-cache directory ("" = disabled). Step
    # programs compile once per (stage, shape); across process restarts the
    # cache turns 20-40 s TPU recompiles into disk loads (utils/platform.py).
    _C.TPU.COMPILE_CACHE_DIR = ""
    # Write checkpoints on a background thread (the device->host fetch stays
    # synchronous — the next step donates the state's buffers — but the
    # GB-scale orbax serialize+write overlaps training; utils/checkpoint.py).
    _C.TPU.ASYNC_CHECKPOINT = False
    # ZeRO-1: shard optimizer moments over the mesh 'data' axis (1/N state
    # per device, bitwise-identical updates; parallel/zero.py). Takes effect
    # whenever training runs over a mesh.
    _C.TPU.ZERO_OPT_STATE = False
    # Keep the decoded train set in HBM and compile whole epochs as one scan
    # (for datasets that fit; Market-1501 at 256x128 is ~1.2 GB uint8).
    # Removes all host round-trips and uploads from the training hot loop.
    _C.TPU.DEVICE_DATASET = False

    _C.OUTPUT_DIR = ""
    return _C


# Module-level singletons mirroring the reference's `from config import cfg`.
cfg = get_default_cfg()
cfg_base = get_default_cfg()
