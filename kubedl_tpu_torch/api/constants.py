"""Well-known labels, annotations and environment variable names.

The port's copy of ``kubedl_tpu/api/constants.py``, whole: the names are
the contract between the control plane and a job's workers, so the
port's entry points (``training/entry.py``, ``serving/server.py``,
``parallel/mesh.py``, ``utils/compile_cache.py``) read the same ones.
The only change is the comment on ``ENV_COMPILE_CACHE_DIR``, which in
the port names the kernel build directory.

Reference analogue: pkg/job_controller/api/v1/constants.go:5-61 (label/
annotation constants) and pkg/apis label conventions. Names are re-derived for
the TPU build (`kubedl-tpu.io/` prefix) — the *semantics* match the reference:
pods are claimed by label selector {group-name, job-name, replica-type,
replica-index, job-role}, and per-job opt-in features ride annotations.
"""

API_GROUP = "kubedl-tpu.io"

# ---- Labels stamped on every pod/service the engine creates --------------
# (reference: pkg/job_controller/pod.go:343-357 label block)
LABEL_GROUP_NAME = API_GROUP + "/group-name"
LABEL_JOB_NAME = API_GROUP + "/job-name"
LABEL_JOB_KIND = API_GROUP + "/job-kind"
LABEL_REPLICA_TYPE = API_GROUP + "/replica-type"
LABEL_REPLICA_INDEX = API_GROUP + "/replica-index"
LABEL_JOB_ROLE = API_GROUP + "/job-role"
LABEL_GANG_NAME = API_GROUP + "/gang-name"
LABEL_CRON_NAME = API_GROUP + "/cron-name"  # reference: cron_controller.go:296-346
LABEL_MODEL_NAME = API_GROUP + "/model-name"

JOB_ROLE_MASTER = "master"

# ---- Annotations (per-job opt-in features) -------------------------------
# reference: pkg/job_controller/api/v1/constants.go:26-42
ANNOTATION_GIT_SYNC_CONFIG = API_GROUP + "/git-sync-config"
ANNOTATION_TENSORBOARD_CONFIG = API_GROUP + "/tensorboard-config"
ANNOTATION_NETWORK_MODE = API_GROUP + "/network-mode"
ANNOTATION_TENANCY = API_GROUP + "/tenancy"
ANNOTATION_OWNER = API_GROUP + "/owner"  # reference: tenancy.go:25-43 user field
ANNOTATION_PROFILER_CONFIG = API_GROUP + "/profiler-config"  # TPU addition
#: monotonic timestamp stamped when the controller began draining a
#: predictor pod ahead of scale-down/GC (docs/serving.md "Router")
ANNOTATION_DRAIN_STARTED = API_GROUP + "/drain-started"
#: world size (total processes) the job was SUBMITTED with — stamped once
#: at first defaulting and stable across elastic resizes, so workers can
#: rescale gradient accumulation to preserve the effective global batch
ANNOTATION_ELASTIC_BASE_WORLD = API_GROUP + "/elastic-base-world"
#: the auto-parallelism planner's cached verdict (kubedl_tpu/planner/):
#: compact JSON {axes, topology, slices, step_ms, hbm_gib}. The cache key
#: is (topology, slices) — an elastic resize changes slices, so the next
#: reconcile re-plans for the new world size (docs/planning.md).
ANNOTATION_PLANNED_MESH = API_GROUP + "/planned-mesh"
#: data-parallel world (replica*data*fsdp of the FIRST plan) — the planner
#: analogue of elastic-base-world: workers rescale grad accumulation
#: against the planned DP degree, not the raw process count, because a
#: re-plan may move chips between data and model axes on resize
ANNOTATION_ELASTIC_BASE_DP = API_GROUP + "/elastic-base-dp"

#: Address of the job's parameter-service tier ("host:port"), stamped by
#: whoever runs it (the PS front is job-external so worker restarts never
#: move it); workers in ``aggregation.mode: ps`` read ENV_PS_ADDR from it.
ANNOTATION_PS_ADDRESS = API_GROUP + "/ps-address"

NETWORK_MODE_HOST = "host"

# ---- Environment variables injected into replicas ------------------------
# TPU bootstrap (replaces TF_CONFIG / MASTER_ADDR / hostfile wiring;
# consumed by jax.distributed.initialize in the worker container):
ENV_COORDINATOR_ADDRESS = "KUBEDL_COORDINATOR_ADDRESS"
ENV_NUM_PROCESSES = "KUBEDL_NUM_PROCESSES"
ENV_PROCESS_ID = "KUBEDL_PROCESS_ID"
ENV_TPU_WORKER_HOSTNAMES = "TPU_WORKER_HOSTNAMES"
ENV_TPU_WORKER_ID = "TPU_WORKER_ID"
ENV_TPU_SLICE_TOPOLOGY = "KUBEDL_SLICE_TOPOLOGY"  # e.g. "v5e-32:4x8"
ENV_MEGASCALE_COORDINATOR = "MEGASCALE_COORDINATOR_ADDRESS"  # multislice DCN
ENV_MEGASCALE_NUM_SLICES = "MEGASCALE_NUM_SLICES"
ENV_MEGASCALE_SLICE_ID = "MEGASCALE_SLICE_ID"
ENV_MESH_AXES = "KUBEDL_MESH_AXES"  # logical mesh hint, e.g. "data=4,model=8"

# Elastic slice scaling (kubedl_tpu/elastic/): the base world size rides
# every elastic worker's env so entry.py can rescale grad accumulation
# (effective global batch is preserved across resizes); min/max ride the
# ElasticDLJob master's env (the reference's master scales its own workers).
ENV_ELASTIC_BASE_WORLD = "KUBEDL_ELASTIC_BASE_WORLD"
#: base data-parallel degree from the planner's first plan; when present,
#: entry.py rescales grad accumulation from base-dp -> current-dp (read
#: off KUBEDL_MESH_AXES) instead of base-world -> world
ENV_ELASTIC_BASE_DP = "KUBEDL_ELASTIC_BASE_DP"
ENV_ELASTIC_MIN_SLICES = "KUBEDL_ELASTIC_MIN_SLICES"
ENV_ELASTIC_MAX_SLICES = "KUBEDL_ELASTIC_MAX_SLICES"
ENV_ELASTIC_NUM_SLICES = "KUBEDL_ELASTIC_NUM_SLICES"

# Parameter-service aggregation (kubedl_tpu/ps/, docs/elasticity.md
# "Parameter-service mode"): a TPUJob whose `aggregation.mode` is "ps"
# stamps the service address and the staleness knobs onto every worker so
# entry.py takes the asynchronous push/pull arm instead of trainer.fit.
ENV_PS_ADDR = "KUBEDL_PS_ADDR"
ENV_PS_SHARDS = "KUBEDL_PS_SHARDS"
ENV_PS_MAX_STALENESS = "KUBEDL_PS_MAX_STALENESS"
ENV_PS_DECAY = "KUBEDL_PS_DECAY"
ENV_PS_PUSH_EVERY = "KUBEDL_PS_PUSH_EVERY"

# Model-output convention (reference: apis/model/v1alpha1/
# modelversion_types.go:23-33 — KUBEDL_MODEL_PATH + /kubedl-model):
ENV_MODEL_PATH = "KUBEDL_MODEL_PATH"
DEFAULT_MODEL_PATH = "/kubedl-model"
#: Checkpoint root for slice-granular restart-from-checkpoint (SURVEY.md §7
#: hard-part b). Defaults to <model path>/checkpoints when unset.
ENV_CKPT_DIR = "KUBEDL_CKPT_DIR"
#: Compile-cache dir, operator-injected alongside the checkpoint dir so
#: gang restarts / resizes / resumes warm-hit instead of re-paying the
#: first-step compile; in the port, the directory its nvcc kernel builds
#: live in (utils/compile_cache.py).
ENV_COMPILE_CACHE_DIR = "KUBEDL_COMPILE_CACHE_DIR"
#: Progress-beacon file (kubedl_tpu/watchdog/): operator-injected per-pod
#: path where the worker's beacon thread stamps {step, tokens, ts}; the
#: kubelet heartbeat publishes it onto the pod's Node object and the
#: watchdog classifies hangs/stragglers/silent deaths from it.
ENV_BEACON_FILE = "KUBEDL_BEACON_FILE"
#: seconds between beacon stamps (default 0.5)
ENV_BEACON_INTERVAL = "KUBEDL_BEACON_INTERVAL"
#: Peer replica root for async checkpointing (training/checkpoint.py):
#: a remote blob URL (http://host:port/prefix) each process mirrors its
#: shard files to, so restore-from-latest survives losing the owning
#: host's local checkpoint dir (preference: local -> peer -> blob store).
ENV_CKPT_PEER = "KUBEDL_CKPT_PEER"

# Default port every replica's coordinator/service listens on.
DEFAULT_PORT = 2222
DEFAULT_PORT_NAME = "kubedl-port"

# Host-network random port range (reference: pkg/job_controller/pod.go:470-486)
HOST_PORT_RANGE = (30001, 65535)
