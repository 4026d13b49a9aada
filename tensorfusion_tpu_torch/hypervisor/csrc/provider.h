/*
 * tpu-fusion accelerator provider ABI (TPU-native).
 *
 * Vendor-neutral C contract between the node hypervisor and a per-platform
 * provider shared library (libtpf_provider_<platform>.so).  This is the
 * TPU-first re-design of the role played by the reference's
 * provider/accelerator.h (NexusGPU/tensor-fusion, accelerator.h:47-446):
 * same responsibilities — enumeration, topology, partitioning, hard limits,
 * snapshot/restore, metrics, mounts, logging — but modeled on TPU hardware:
 *
 *   - the unit of allocation is a *chip* with one or more TensorCores and a
 *     fixed HBM capacity; fractional use is expressed as an MXU duty-cycle
 *     share plus an HBM byte budget (instead of SM counts / MIG profiles);
 *   - topology is an ICI mesh (per-chip (x,y,z) coordinates inside a slice,
 *     wrap-around torus flags, link tiers SELF / SAME_CHIP / ICI one-hop /
 *     ICI routed / DCN) instead of the PCIe/NVLink 7-level enum
 *     (reference accelerator.h:134-143);
 *   - "partitioning" grants whole TensorCores of a chip (e.g. the two cores
 *     of a v5p chip) rather than MIG slices.
 *
 * Providers are dlopen()ed by the hypervisor with ctypes/dlopen; every entry
 * point uses C linkage and caller-allocated fixed-size structs so the ABI is
 * stable without a C++ runtime dependency.
 */

#ifndef TPUFUSION_PROVIDER_H
#define TPUFUSION_PROVIDER_H

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

#define TPF_API __attribute__((visibility("default")))

/* ------------------------------------------------------------------ */
/* Status codes                                                        */
/* ------------------------------------------------------------------ */

typedef enum {
  TPF_OK = 0,
  TPF_ERR_INVALID_ARG = 1,
  TPF_ERR_NOT_FOUND = 2,
  TPF_ERR_UNSUPPORTED = 3,
  TPF_ERR_EXHAUSTED = 4,
  TPF_ERR_FAILED = 5,
  TPF_ERR_INTERNAL = 6,
  TPF_ERR_NOT_INITIALIZED = 7
} tpf_status_t;

/* ------------------------------------------------------------------ */
/* Sizing constants                                                    */
/* ------------------------------------------------------------------ */

#define TPF_ID_LEN 64
#define TPF_NAME_LEN 96
#define TPF_PATH_LEN 512
#define TPF_MAX_CHIPS 256          /* max chips on one host / in one topology */
#define TPF_MAX_PARTITION_ENV 16
#define TPF_ENV_LEN 256
#define TPF_MAX_PARTITION_NODES 16
#define TPF_MAX_EXTRA_METRICS 32
#define TPF_MAX_TEMPLATES 16

/* ------------------------------------------------------------------ */
/* Chip enumeration                                                    */
/* ------------------------------------------------------------------ */

/* What virtualization features this provider supports for a chip. */
typedef struct {
  uint8_t core_partitioning;  /* can grant individual TensorCores           */
  uint8_t soft_isolation;     /* shm token-bucket metering supported        */
  uint8_t hard_isolation;     /* one-shot HBM / duty-cycle caps supported   */
  uint8_t snapshot;           /* snapshot/restore of device state supported */
  uint8_t metrics;            /* per-chip + per-process metrics supported   */
  uint8_t remoting;           /* remote-vTPU serving supported              */
  uint32_t max_partitions;    /* usually == core_count                      */
  uint32_t max_workers;       /* concurrent soft-isolated workers per chip  */
} tpf_chip_caps_t;

typedef struct {
  char chip_id[TPF_ID_LEN];      /* stable unique id, e.g. "v5e-host0-c3"   */
  char platform[32];             /* "tpu" (mock providers still say "tpu")  */
  char generation[32];           /* "v4" | "v5e" | "v5p" | "v6e" | ...      */
  char slice_id[TPF_ID_LEN];     /* pod-slice this chip belongs to          */
  char device_path[TPF_PATH_LEN];/* e.g. "/dev/accel3"                      */
  char driver_version[48];       /* libtpu / driver build id                */
  int32_t global_index;          /* index across the slice                  */
  int32_t host_index;            /* index on this host (visible-chips id)   */
  int32_t numa_node;             /* host NUMA node, -1 if unknown           */
  int32_t core_count;            /* TensorCores per chip (v5e:1, v5p:2)     */
  uint64_t hbm_bytes;            /* HBM capacity                            */
  double peak_bf16_tflops;       /* MXU peak, bf16                          */
  double peak_int8_tops;         /* MXU peak, int8                          */
  double hbm_gbps;               /* HBM bandwidth                           */
  int32_t mesh_x, mesh_y, mesh_z;/* ICI coordinates within the slice        */
  tpf_chip_caps_t caps;
} tpf_chip_info_t;

/* ------------------------------------------------------------------ */
/* ICI topology                                                        */
/* ------------------------------------------------------------------ */

typedef enum {
  TPF_LINK_SELF = 0,       /* same chip                                     */
  TPF_LINK_SAME_CHIP = 1,  /* two cores of one chip (megacore pairing)      */
  TPF_LINK_ICI = 2,        /* direct ICI neighbor (1 hop)                   */
  TPF_LINK_ICI_ROUTED = 3, /* same slice, routed over >1 ICI hop            */
  TPF_LINK_DCN = 4,        /* different slice; data-center network          */
  TPF_LINK_NONE = 5        /* unreachable / unknown                         */
} tpf_link_kind_t;

typedef struct {
  char peer_chip_id[TPF_ID_LEN];
  int32_t peer_index;      /* host_index of the peer                        */
  tpf_link_kind_t kind;
  int32_t hops;            /* ICI hop count (0 for SELF/SAME_CHIP, -1 n/a)  */
  double gbps;             /* per-direction link bandwidth estimate         */
} tpf_link_t;

typedef struct {
  char chip_id[TPF_ID_LEN];
  int32_t index;
  int32_t mesh_x, mesh_y, mesh_z;
  tpf_link_t links[TPF_MAX_CHIPS];
  size_t link_count;
} tpf_topo_row_t;

typedef struct {
  int32_t mesh_shape[3];   /* slice mesh shape, unused dims = 1             */
  uint8_t wraparound[3];   /* torus wrap per axis                           */
  tpf_topo_row_t rows[TPF_MAX_CHIPS];
  size_t row_count;
} tpf_topology_t;

/* ------------------------------------------------------------------ */
/* Core partitioning                                                   */
/* ------------------------------------------------------------------ */

/* A partition template describes a grantable sub-chip unit (N TensorCores
 * with a proportional HBM share), the TPU analog of a MIG profile. */
typedef struct {
  char template_id[TPF_ID_LEN];  /* e.g. "v5p-1c"                           */
  char name[TPF_NAME_LEN];
  int32_t core_count;
  uint64_t hbm_bytes;
  double bf16_tflops;
  uint32_t slots;                /* how many fit on one chip                */
  uint8_t is_default;
} tpf_partition_template_t;

typedef enum {
  TPF_GRANT_ENV = 0,         /* expressed as env vars for the worker        */
  TPF_GRANT_DEVICE_NODE = 1  /* expressed as device nodes to mount          */
} tpf_grant_kind_t;

typedef struct {
  tpf_grant_kind_t kind;
  char chip_id[TPF_ID_LEN];
  char partition_id[TPF_ID_LEN];              /* provider-assigned instance */
  char env[TPF_MAX_PARTITION_ENV][TPF_ENV_LEN];   /* "KEY=VALUE" entries    */
  size_t env_count;
  char device_nodes[TPF_MAX_PARTITION_NODES][TPF_PATH_LEN * 2 + 2]; /* "host=guest" */
  size_t device_node_count;
} tpf_partition_grant_t;

/* ------------------------------------------------------------------ */
/* Snapshot / restore (live migration)                                 */
/* ------------------------------------------------------------------ */

typedef struct {
  const int64_t* pids;     /* process-level snapshot; NULL for device-level */
  size_t pid_count;
  const char* chip_id;     /* device-level snapshot; NULL for process-level */
  const char* state_dir;   /* where to persist / load HBM + executable state */
} tpf_snapshot_ctx_t;

/* ------------------------------------------------------------------ */
/* Metrics                                                             */
/* ------------------------------------------------------------------ */

typedef struct {
  char key[TPF_ID_LEN];
  double value;
} tpf_kv_metric_t;

typedef struct {
  char chip_id[TPF_ID_LEN];
  double duty_cycle_pct;       /* MXU busy fraction, 0-100                  */
  double hbm_bw_util_pct;      /* HBM bandwidth utilization, 0-100          */
  uint64_t hbm_used_bytes;
  double power_watts;
  double temp_celsius;
  uint64_t ici_tx_bytes;
  uint64_t ici_rx_bytes;
  tpf_kv_metric_t extra[TPF_MAX_EXTRA_METRICS];
  size_t extra_count;
} tpf_chip_metrics_t;

typedef struct {
  int64_t pid;
  char chip_id[TPF_ID_LEN];
  double duty_cycle_pct;       /* share of chip MXU time this process used  */
  uint64_t hbm_used_bytes;
  uint64_t hbm_reserved_bytes;
  uint64_t programs_launched;  /* XLA executable launches observed          */
} tpf_proc_stats_t;

typedef struct {
  char host_path[TPF_PATH_LEN];
  char guest_path[TPF_PATH_LEN];
} tpf_mount_t;

/* Log sink: level is "debug"|"info"|"warn"|"error". */
typedef void (*tpf_log_fn)(const char* level, const char* message);

/* ------------------------------------------------------------------ */
/* Entry points (17-function surface, mirroring reference parity)      */
/* ------------------------------------------------------------------ */

TPF_API tpf_status_t tpf_init(void);
TPF_API tpf_status_t tpf_shutdown(void);

TPF_API tpf_status_t tpf_chip_count(size_t* count);
TPF_API tpf_status_t tpf_enumerate(tpf_chip_info_t* chips, size_t max_count,
                                   size_t* count);
TPF_API tpf_status_t tpf_topology(tpf_topology_t* topology);

TPF_API tpf_status_t tpf_partition_templates(const char* chip_id,
                                             tpf_partition_template_t* out,
                                             size_t max_count, size_t* count);
TPF_API tpf_status_t tpf_partition_create(const char* template_id,
                                          const char* chip_id,
                                          tpf_partition_grant_t* grant);
TPF_API tpf_status_t tpf_partition_destroy(const char* template_id,
                                           const char* chip_id);

TPF_API tpf_status_t tpf_set_hbm_hard_limit(const char* chip_id,
                                            uint64_t limit_bytes);
TPF_API tpf_status_t tpf_set_duty_hard_limit(const char* chip_id,
                                             uint32_t duty_pct);

TPF_API tpf_status_t tpf_snapshot(const tpf_snapshot_ctx_t* ctx);
TPF_API tpf_status_t tpf_restore(const tpf_snapshot_ctx_t* ctx);

TPF_API tpf_status_t tpf_proc_stats(tpf_proc_stats_t* out, size_t max_count,
                                    size_t* count);
TPF_API tpf_status_t tpf_chip_metrics(const char** chip_ids, size_t chip_count,
                                      tpf_chip_metrics_t* out);
TPF_API tpf_status_t tpf_mounts(tpf_mount_t* out, size_t max_count,
                                size_t* count);

TPF_API tpf_status_t tpf_set_log_sink(tpf_log_fn sink);

/* ABI version of this header; returned by providers for compat checks. */
#define TPF_PROVIDER_ABI_VERSION 1
TPF_API uint32_t tpf_abi_version(void);

#ifdef __cplusplus
}
#endif

#endif /* TPUFUSION_PROVIDER_H */
