"""Default configuration tree of the PyTorch port.

The port's own copy of ``nmrf_tpu/config/defaults.py``: the keys are the
same, so the same YAML configs and override strings drive both packages,
but for the port's own ``MODEL.ARCH`` and its ``RAFT`` and ``IGEV`` nodes
(the port's second and third architectures, RAFT-Stereo and IGEV-Stereo).
The ``TPU`` node keeps its name; in the port its keys mean what the
comments below say.
"""

from .config import CfgNode as CN


def get_cfg() -> CN:
    _C = CN()
    _C.VERSION = 2

    # ---- Model ----
    # The architecture ``build_model`` builds: "nmrf", "raft_stereo" or
    # "igev_stereo" (the port's own key, with the RAFT and IGEV nodes below;
    # the JAX package has none of them).  "nmrf" reads every node from
    # BACKBONE on, and neither RAFT nor IGEV.
    _C.MODEL = CN()
    _C.MODEL.ARCH = "nmrf"

    # RAFT-Stereo at the defaults of its train_stereo.py/evaluate_stereo.py
    # (models/raft_stereo.py, where 3 GRU levels and a batch-norm context
    # are fixed); read under MODEL.ARCH "raft_stereo" and "igev_stereo",
    # whose update loop takes the same five keys (IGEV-Stereo's defaults
    # differ in CORR_LEVELS, 2, and its N_DOWNSAMPLE must be 2).
    _C.RAFT = CN()
    _C.RAFT.HIDDEN_DIMS = [128, 128, 128]
    _C.RAFT.N_DOWNSAMPLE = 2
    _C.RAFT.CORR_LEVELS = 4
    _C.RAFT.CORR_RADIUS = 4
    _C.RAFT.VALID_ITERS = 32

    # IGEV-Stereo's own key (models/igev_stereo.py): the geometry encoding
    # volume's maximum disparity at full resolution (MAX_DISP / 4 at 1/4, a
    # multiple of 32); read only under MODEL.ARCH "igev_stereo".
    _C.IGEV = CN()
    _C.IGEV.MAX_DISP = 192

    _C.BACKBONE = CN()
    _C.BACKBONE.MODEL_TYPE = "resnet"
    _C.BACKBONE.NORM_FN = "instance"
    _C.BACKBONE.OUT_CHANNELS = 256
    _C.BACKBONE.WEIGHT_URL = ""
    _C.BACKBONE.DROP_PATH = 0.0
    _C.BACKBONE.COMPAT = True

    _C.DPN = CN()
    _C.DPN.MAX_DISP = 320
    _C.DPN.COST_GROUP = 4
    _C.DPN.NUM_PROPOSALS = 4
    _C.DPN.CONTEXT_DIM = 64

    _C.NMP = CN()
    _C.NMP.PROP_EMBED_DIM = 128
    _C.NMP.INFER_EMBED_DIM = 128
    _C.NMP.MLP_RATIO = 4
    _C.NMP.SPLIT_SIZE = 1
    _C.NMP.WINDOW_SIZE = 6
    _C.NMP.REFINE_WINDOW_SIZE = 4
    _C.NMP.PROP_N_HEADS = 4
    _C.NMP.INFER_N_HEADS = 4
    _C.NMP.NUM_PROP_LAYERS = 5
    _C.NMP.NUM_INFER_LAYERS = 5
    _C.NMP.NUM_REFINE_LAYERS = 5
    _C.NMP.RETURN_INTERMEDIATE = True
    _C.NMP.ATTN_DROP = 0.0
    _C.NMP.PROJ_DROP = 0.0
    _C.NMP.DROP_PATH = 0.0
    _C.NMP.DROPOUT = 0.0
    _C.NMP.NORMALIZE_BEFORE = True
    _C.NMP.WITH_REFINEMENT = True

    # ---- Datasets / augmentation ----
    _C.DATASETS = CN()
    _C.DATASETS.TRAIN = ["sceneflow"]
    _C.DATASETS.TEST = ["things"]
    _C.DATASETS.IMG_GAMMA = None
    _C.DATASETS.SATURATION_RANGE = [0.0, 1.4]
    _C.DATASETS.DO_FLIP = False
    _C.DATASETS.SPATIAL_SCALE = [-0.2, 0.4]
    _C.DATASETS.YJITTER = False
    _C.DATASETS.CROP_SIZE = [384, 768]
    _C.DATASETS.DIVIS_BY = 8
    # Root directory for dataset files (reference hardcodes `datasets/`)
    _C.DATASETS.ROOT = "datasets"

    _C.DATALOADER = CN()
    _C.DATALOADER.NUM_WORKERS = 4
    # Decode/augment in a spawn-context process pool (the torch num_workers
    # equivalent; threads are GIL-bound to ~1 core).  Recommended on for
    # real training hosts; off by default so tiny runs skip worker startup.
    _C.DATALOADER.USE_PROCESSES = False

    # ---- Solver ----
    _C.SOLVER = CN()
    _C.SOLVER.MAX_ITER = 300000
    _C.SOLVER.BASE_LR = 0.0005
    _C.SOLVER.BASE_LR_END = 0.0
    _C.SOLVER.BACKBONE_LR_DECAY = 0.1
    _C.SOLVER.WEIGHT_DECAY = 0.00001
    _C.SOLVER.WEIGHT_DECAY_NORM = 0.00001
    _C.SOLVER.BACKBONE_WEIGHT_DECAY = 0.00001
    _C.SOLVER.CHECKPOINT_PERIOD = 100000
    _C.SOLVER.LATEST_CHECKPOINT_PERIOD = 1000
    _C.SOLVER.IMS_PER_BATCH = 8
    _C.SOLVER.GRAD_CLIP = 1.0
    # Accumulate gradients over this many microbatches per optimizer update
    # (optax.MultiSteps; 1 = reference behavior).  Effective batch =
    # IMS_PER_BATCH * ACCUM_STEPS; the LR schedule advances per update.
    _C.SOLVER.ACCUM_STEPS = 1
    _C.SOLVER.LOSS_WEIGHTS = [1.0, 1.0, 1.0, 1.4, 1.4, 1.4, 1.4, 1.6, 2.0, 2.0]
    _C.SOLVER.RESUME = None
    _C.SOLVER.STRICT_RESUME = True
    _C.SOLVER.NO_RESUME_OPTIMIZER = False
    _C.SOLVER.AUX_LOSS = True
    _C.SOLVER.MAX_DISP = 192
    _C.SOLVER.LOSS_TYPE = "L1"
    # Fix for reference snapshot defect: the proposal matching loss is emitted
    # under key 'loss_prop' but weighted under 'proposal_disp' (reference
    # NMRF.py:434 vs :318), silently zeroing its gradient.  True => weight it.
    _C.SOLVER.FIX_PROPOSAL_LOSS_WEIGHT = True

    # ---- Test ----
    _C.TEST = CN()
    _C.TEST.EVAL_PERIOD = 20000
    _C.TEST.EVAL_THRESH = [["1.0", "3.0"]]
    _C.TEST.EVAL_MAX_DISP = [192]
    _C.TEST.EVAL_ONLY_VALID = [True]
    _C.TEST.EVAL_PROP = [True]

    # ---- Misc ----
    _C.SEED = 326
    _C.CUDNN_BENCHMARK = True  # accepted for config compat; no-op on TPU

    _C.GLOBAL = CN()
    _C.GLOBAL.HACK = 1.0

    # ---- Accelerator knobs (node name shared with the JAX package) ----
    _C.TPU = CN()
    # Compute dtype for the forward pass: "float32" or "bfloat16".  Norms,
    # softmax and all disparity arithmetic stay float32 either way.
    _C.TPU.COMPUTE_DTYPE = "float32"
    # Multi-device layout (not used by the port yet).
    _C.TPU.MESH_DATA = -1
    _C.TPU.MESH_SPATIAL = 1
    # Route the NMP window and stripe attention through the hand-written
    # CUDA kernels (ops/attention.py) for CUDA tensors; False runs those
    # kernels' plain PyTorch versions.
    _C.TPU.USE_PALLAS = True
    # Swin-variant knobs, kept so configs of the JAX package load unchanged.
    _C.TPU.MSDA_TAP_RADIUS = 5
    _C.TPU.MSDA_OOB_THRESH = 1e-3
    _C.TPU.MSDA_OOB_FALLBACK = False
    # Lower GELU to the tanh approximation inside bf16 compute (the f32 path
    # always keeps the exact erf form).
    _C.TPU.GELU_APPROX = False
    # Eval-time padding bucket (kept for config compatibility).
    _C.TPU.EVAL_BUCKET = 64
    # Per-layer activation checkpointing in training: every propagation,
    # inference and refinement layer runs under torch.utils.checkpoint.
    _C.TPU.REMAT = False

    return _C
