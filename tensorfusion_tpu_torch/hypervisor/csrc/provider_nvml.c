/*
 * NVIDIA provider: implements the tpu-fusion provider ABI (provider.h, a
 * byte-equal copy of native/include/tpufusion/provider.h) over NVML
 * (libtpf_provider_nvml.so).  It stands beside the PJRT provider
 * (native/provider/pjrt/provider_pjrt.cc) and follows its structure: one
 * mutex, an `initialized` flag, and a device table that tpf_init fills.
 *
 * NVML is loaded with dlopen("libnvidia-ml.so.1") at tpf_init (the path is
 * overridable by TPF_NVML_LIB, which the tests point at fake_nvml.c), and
 * every function is resolved with dlsym: the provider neither links
 * -lnvidia-ml nor includes nvml.h.  The types it needs are declared in
 * nvml_types.h and checked against the toolkit's header by
 * nvml_layout_check.c.  A missing library or symbol, an nvmlInit_v2 that
 * fails, no GPU, or a card outside the datasheet table below makes tpf_init
 * fail with a log line; it never returns OK with zero chips or made-up
 * peaks.
 *
 * The ABI's concepts on a GPU:
 *
 *   chips        <- NVML devices: chip_id is the NVML UUID ("GPU-..."),
 *                   platform "gpu", the generation and peaks from the
 *                   device name (H100 SXM, PCIe, NVL), one "core" a card,
 *                   mesh_x = the NVML index, the NUMA node from
 *                   <sysfs>/bus/pci/devices/<busId>/numa_node (-1 where
 *                   NVML gives no PCI info or sysfs has no entry)
 *   topology     <- a row a card.  Peers map onto the reference's link
 *                   enum, which stays as it is:
 *                     NVLink peer (P2P NVLink status OK)       -> TPF_LINK_ICI (1 hop)
 *                     common ancestor a PCIe switch, a host
 *                     bridge or one NUMA node                  -> TPF_LINK_ICI_ROUTED
 *                     across NUMA nodes (NVML "system")        -> TPF_LINK_DCN
 *                     NVML does not say                        -> TPF_LINK_NONE
 *   partitions   <- the whole card only ("<gen>-full", one slot), granted
 *                   as env CUDA_VISIBLE_DEVICES=<UUID>; MIG profiles are
 *                   not offered yet
 *   hard limits  <- recorded per card and surfaced in the chip metrics,
 *                   as the PJRT provider does.  NVML has no per-process
 *                   duty cap (nor a memory cap for another process), so
 *                   nothing on the card enforces them: a share is enforced
 *                   by the soft limiter's token buckets
 *   snapshot     <- a manifest of the card's memory use and partitions and
 *                   a frozen mark (device level), or the pid set (process
 *                   level), written and re-adopted as the PJRT provider
 *                   does
 *   metrics      <- nvmlDeviceGetUtilizationRates (duty, memory-bandwidth
 *                   share), GetMemoryInfo, GetPowerUsage, GetTemperature,
 *                   GetPowerManagementLimit (extra "power_limit_w")
 *   proc stats   <- nvmlDeviceGetComputeRunningProcesses_v3 (pids, memory)
 *                   joined with nvmlDeviceGetProcessUtilization since this
 *                   provider's last call (smUtil averaged over the samples;
 *                   NVML_ERROR_NOT_FOUND, no new sample, is 0%).  NVML
 *                   reports host pids.  Where NVML does not support
 *                   per-process utilization, duty is 0 and the chip
 *                   metrics say so (extra "proc_util_supported" = 0).
 */

#define _GNU_SOURCE
#include <dlfcn.h>
#include <pthread.h>
#include <stdarg.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <unistd.h>

#include "nvml_types.h"
#include "provider.h"

/* ---- NVML entry points, resolved at tpf_init ---------------------------- */

#define NVML_SYMBOLS(X)                                                          \
  X(nvmlInit_v2, nv_return_t, (void))                                            \
  X(nvmlShutdown, nv_return_t, (void))                                           \
  X(nvmlErrorString, const char*, (nv_return_t))                                 \
  X(nvmlSystemGetDriverVersion, nv_return_t, (char*, unsigned int))              \
  X(nvmlDeviceGetCount_v2, nv_return_t, (unsigned int*))                         \
  X(nvmlDeviceGetHandleByIndex_v2, nv_return_t, (unsigned int, nv_device_t*))    \
  X(nvmlDeviceGetName, nv_return_t, (nv_device_t, char*, unsigned int))          \
  X(nvmlDeviceGetUUID, nv_return_t, (nv_device_t, char*, unsigned int))          \
  X(nvmlDeviceGetMinorNumber, nv_return_t, (nv_device_t, unsigned int*))         \
  X(nvmlDeviceGetPciInfo_v3, nv_return_t, (nv_device_t, nv_pci_info_t*))         \
  X(nvmlDeviceGetMemoryInfo, nv_return_t, (nv_device_t, nv_memory_t*))           \
  X(nvmlDeviceGetTopologyCommonAncestor, nv_return_t,                            \
    (nv_device_t, nv_device_t, int*))                                            \
  X(nvmlDeviceGetP2PStatus, nv_return_t, (nv_device_t, nv_device_t, int, int*))  \
  X(nvmlDeviceGetUtilizationRates, nv_return_t, (nv_device_t, nv_utilization_t*)) \
  X(nvmlDeviceGetPowerUsage, nv_return_t, (nv_device_t, unsigned int*))          \
  X(nvmlDeviceGetPowerManagementLimit, nv_return_t, (nv_device_t, unsigned int*)) \
  X(nvmlDeviceGetTemperature, nv_return_t, (nv_device_t, int, unsigned int*))    \
  X(nvmlDeviceGetComputeRunningProcesses_v3, nv_return_t,                        \
    (nv_device_t, unsigned int*, nv_process_info_t*))                            \
  X(nvmlDeviceGetProcessUtilization, nv_return_t,                                \
    (nv_device_t, nv_process_utilization_sample_t*, unsigned int*,               \
     unsigned long long))

#define DECLARE_FN(name, ret, args) ret(*name) args;
static struct { NVML_SYMBOLS(DECLARE_FN) } nv;

/* ---- datasheet table ----------------------------------------------------- */

/* NVIDIA's H100 datasheet, dense rates (no sparsity); the same figures as
 * tensorfusion_tpu_torch/hardware.py.  The first match in the device name
 * wins, so the SXM row ("H100") comes last. */
typedef struct {
  const char* match;
  const char* gen;
  double bf16_tflops;
  double int8_tops;
  double hbm_gbps;
  double nvlink_gbps;  /* per direction */
} gen_info_t;

static const gen_info_t kGens[] = {
    {"H100 PCIe", "h100-pcie", 756.0, 1513.0, 2000.0, 300.0},
    {"H100 NVL", "h100-nvl", 835.0, 1671.0, 3900.0, 300.0},
    {"H100", "h100-sxm", 989.0, 1979.0, 3350.0, 450.0},
};

#define PCIE_GBPS 64.0  /* PCIe Gen5 x16, per direction */
#define MAX_SAMPLES 1024

/* ---- state ---------------------------------------------------------------- */

typedef struct {
  nv_device_t handle;
  unsigned int index;
  char uuid[TPF_ID_LEN];
  char name[TPF_NAME_LEN];
  const gen_info_t* gen;
  uint64_t hbm_bytes;
  int32_t numa_node;
  char device_path[TPF_PATH_LEN];
  char partition_id[TPF_ID_LEN];     /* "" = the card is not granted */
  size_t next_partition_seq;
  uint64_t hbm_hard_limit;           /* 0 = unlimited */
  uint32_t duty_hard_limit;
  int frozen;                        /* device-level snapshot in progress */
  unsigned long long last_seen_ts;   /* newest utilization sample read */
} device_t;

static struct {
  void* lib;
  int initialized;
  int proc_util_supported;
  tpf_log_fn log_sink;
  char driver_version[48];
  char host[TPF_ID_LEN];
  size_t count;
  device_t devices[TPF_MAX_CHIPS];
} g;

static pthread_mutex_t g_mu = PTHREAD_MUTEX_INITIALIZER;

static void logf_(const char* level, const char* fmt, ...)
    __attribute__((format(printf, 2, 3)));
static void logf_(const char* level, const char* fmt, ...) {
  if (!g.log_sink) return;
  char msg[768];
  va_list ap;
  va_start(ap, fmt);
  vsnprintf(msg, sizeof(msg), fmt, ap);
  va_end(ap);
  g.log_sink(level, msg);
}

static const char* nv_error(nv_return_t rc) {
  const char* s = nv.nvmlErrorString ? nv.nvmlErrorString(rc) : NULL;
  return s ? s : "unknown NVML error";
}

static int find_device_locked(const char* chip_id) {
  for (size_t i = 0; i < g.count; ++i)
    if (strcmp(g.devices[i].uuid, chip_id) == 0) return (int)i;
  return -1;
}

static void copy_str(char* dst, size_t n, const char* src) {
  snprintf(dst, n, "%s", src);
}

/* NUMA node of a PCI function from sysfs; -1 where unknown. */
static int32_t read_numa_node(unsigned int domain, unsigned int bus,
                              unsigned int device) {
  const char* root = getenv("TPF_NVML_SYSFS");
  char path[TPF_PATH_LEN];
  snprintf(path, sizeof(path), "%s/bus/pci/devices/%04x:%02x:%02x.0/numa_node",
           root && *root ? root : "/sys", domain, bus, device);
  FILE* f = fopen(path, "r");
  if (!f) return -1;
  int node = -1;
  if (fscanf(f, "%d", &node) != 1) node = -1;
  fclose(f);
  return node < 0 ? -1 : node;
}

static void close_nvml_locked(void) {
  if (g.lib) dlclose(g.lib);
  g.lib = NULL;
  memset(&nv, 0, sizeof(nv));
}

/* Fills device i of the table; returns 0, or -1 after logging. */
static int open_device_locked(unsigned int i) {
  device_t* d = &g.devices[i];
  memset(d, 0, sizeof(*d));
  d->index = i;
  d->duty_hard_limit = 100;
  d->numa_node = -1;
  nv_return_t rc = nv.nvmlDeviceGetHandleByIndex_v2(i, &d->handle);
  if (rc != NV_SUCCESS) {
    logf_("error", "nvmlDeviceGetHandleByIndex_v2(%u) failed: %s", i, nv_error(rc));
    return -1;
  }
  char name[NV_DEVICE_NAME_BUFFER_SIZE] = {0};
  rc = nv.nvmlDeviceGetName(d->handle, name, sizeof(name));
  if (rc != NV_SUCCESS) {
    logf_("error", "nvmlDeviceGetName(GPU %u) failed: %s", i, nv_error(rc));
    return -1;
  }
  copy_str(d->name, sizeof(d->name), name);
  for (size_t k = 0; k < sizeof(kGens) / sizeof(kGens[0]); ++k) {
    if (strstr(name, kGens[k].match)) {
      d->gen = &kGens[k];
      break;
    }
  }
  if (!d->gen) {
    logf_("error", "GPU %u is a %s: no datasheet peaks known for it (this "
          "provider knows the H100 SXM, PCIe and NVL)", i, name);
    return -1;
  }
  char uuid[NV_DEVICE_UUID_BUFFER_SIZE] = {0};
  rc = nv.nvmlDeviceGetUUID(d->handle, uuid, sizeof(uuid));
  if (rc != NV_SUCCESS || uuid[0] == '\0' || strlen(uuid) >= TPF_ID_LEN) {
    logf_("error", "nvmlDeviceGetUUID(GPU %u) failed: %s", i,
          rc != NV_SUCCESS ? nv_error(rc) : "empty or too long");
    return -1;
  }
  copy_str(d->uuid, sizeof(d->uuid), uuid);
  nv_memory_t mem;
  rc = nv.nvmlDeviceGetMemoryInfo(d->handle, &mem);
  if (rc != NV_SUCCESS || mem.total == 0) {
    logf_("error", "nvmlDeviceGetMemoryInfo(GPU %u) failed: %s", i,
          rc != NV_SUCCESS ? nv_error(rc) : "zero memory");
    return -1;
  }
  d->hbm_bytes = mem.total;
  unsigned int minor = 0;
  if (nv.nvmlDeviceGetMinorNumber(d->handle, &minor) == NV_SUCCESS)
    snprintf(d->device_path, sizeof(d->device_path), "/dev/nvidia%u", minor);
  nv_pci_info_t pci;
  rc = nv.nvmlDeviceGetPciInfo_v3(d->handle, &pci);
  if (rc == NV_SUCCESS)
    d->numa_node = read_numa_node(pci.domain, pci.bus, pci.device);
  else
    logf_("info", "no PCI info for GPU %u (%s): NUMA node unknown", i, nv_error(rc));
  return 0;
}

/* ---- lifecycle ------------------------------------------------------------ */

TPF_API uint32_t tpf_abi_version(void) { return TPF_PROVIDER_ABI_VERSION; }

TPF_API tpf_status_t tpf_set_log_sink(tpf_log_fn sink) {
  pthread_mutex_lock(&g_mu);
  g.log_sink = sink;
  pthread_mutex_unlock(&g_mu);
  return TPF_OK;
}

static tpf_status_t init_locked(void) {
  if (g.initialized) return TPF_OK;
  const char* path = getenv("TPF_NVML_LIB");
  if (!path || !*path) path = "libnvidia-ml.so.1";
  g.lib = dlopen(path, RTLD_NOW | RTLD_LOCAL);
  if (!g.lib) {
    logf_("error", "cannot load NVML (%s): %s", path, dlerror());
    return TPF_ERR_FAILED;
  }
#define RESOLVE_FN(name, ret, args)                                         \
  *(void**)(&nv.name) = dlsym(g.lib, #name);                                \
  if (!nv.name) {                                                           \
    logf_("error", "NVML library %s has no symbol %s", path, #name);        \
    close_nvml_locked();                                                    \
    return TPF_ERR_FAILED;                                                  \
  }
  NVML_SYMBOLS(RESOLVE_FN)
#undef RESOLVE_FN
  nv_return_t rc = nv.nvmlInit_v2();
  if (rc != NV_SUCCESS) {
    logf_("error", "nvmlInit_v2 failed: %s", nv_error(rc));
    close_nvml_locked();
    return TPF_ERR_FAILED;
  }
  unsigned int n = 0;
  rc = nv.nvmlDeviceGetCount_v2(&n);
  if (rc != NV_SUCCESS || n == 0 || n > TPF_MAX_CHIPS) {
    if (rc != NV_SUCCESS)
      logf_("error", "nvmlDeviceGetCount_v2 failed: %s", nv_error(rc));
    else
      logf_("error", "NVML reports %u GPUs", n);
    nv.nvmlShutdown();
    close_nvml_locked();
    return TPF_ERR_FAILED;
  }
  for (unsigned int i = 0; i < n; ++i) {
    int bad = open_device_locked(i);
    for (unsigned int j = 0; !bad && j < i; ++j) {
      if (strcmp(g.devices[j].uuid, g.devices[i].uuid) == 0) {
        logf_("error", "GPUs %u and %u report the same UUID %s", j, i,
              g.devices[i].uuid);
        bad = 1;
      }
    }
    if (bad) {
      nv.nvmlShutdown();
      close_nvml_locked();
      return TPF_ERR_FAILED;
    }
  }
  g.count = n;
  g.driver_version[0] = '\0';
  char version[NV_DRIVER_VERSION_BUFFER_SIZE] = {0};
  if (nv.nvmlSystemGetDriverVersion(version, sizeof(version)) == NV_SUCCESS)
    copy_str(g.driver_version, sizeof(g.driver_version), version);
  if (gethostname(g.host, sizeof(g.host)) != 0) g.host[0] = '\0';
  g.host[sizeof(g.host) - 1] = '\0';
  g.proc_util_supported = 1;
  g.initialized = 1;
  logf_("info", "NVML provider: %u GPU(s) (%s), driver %s", n, g.devices[0].name,
        g.driver_version[0] ? g.driver_version : "unknown");
  return TPF_OK;
}

TPF_API tpf_status_t tpf_init(void) {
  pthread_mutex_lock(&g_mu);
  tpf_status_t st = init_locked();
  pthread_mutex_unlock(&g_mu);
  return st;
}

TPF_API tpf_status_t tpf_shutdown(void) {
  pthread_mutex_lock(&g_mu);
  if (g.initialized) nv.nvmlShutdown();
  close_nvml_locked();
  g.count = 0;
  g.initialized = 0;
  pthread_mutex_unlock(&g_mu);
  return TPF_OK;
}

/* ---- enumeration and topology --------------------------------------------- */

TPF_API tpf_status_t tpf_chip_count(size_t* count) {
  pthread_mutex_lock(&g_mu);
  tpf_status_t st = TPF_OK;
  if (!g.initialized) st = TPF_ERR_NOT_INITIALIZED;
  else if (!count) st = TPF_ERR_INVALID_ARG;
  else *count = g.count;
  pthread_mutex_unlock(&g_mu);
  return st;
}

static void fill_chip_info(const device_t* d, tpf_chip_info_t* ci) {
  memset(ci, 0, sizeof(*ci));
  copy_str(ci->chip_id, sizeof(ci->chip_id), d->uuid);
  copy_str(ci->platform, sizeof(ci->platform), "gpu");
  copy_str(ci->generation, sizeof(ci->generation), d->gen->gen);
  copy_str(ci->slice_id, sizeof(ci->slice_id), g.host);
  copy_str(ci->device_path, sizeof(ci->device_path), d->device_path);
  copy_str(ci->driver_version, sizeof(ci->driver_version), g.driver_version);
  ci->global_index = (int32_t)d->index;
  ci->host_index = (int32_t)d->index;
  ci->numa_node = d->numa_node;
  ci->core_count = 1;
  ci->hbm_bytes = d->hbm_bytes;
  ci->peak_bf16_tflops = d->gen->bf16_tflops;
  ci->peak_int8_tops = d->gen->int8_tops;
  ci->hbm_gbps = d->gen->hbm_gbps;
  ci->mesh_x = (int32_t)d->index;
  ci->caps.core_partitioning = 0;
  ci->caps.soft_isolation = 1;   /* the limiter's token buckets */
  ci->caps.hard_isolation = 0;   /* NVML can cap no process (header comment) */
  ci->caps.snapshot = 1;
  ci->caps.metrics = 1;
  ci->caps.remoting = 1;
  ci->caps.max_partitions = 1;
  ci->caps.max_workers = 16;
}

TPF_API tpf_status_t tpf_enumerate(tpf_chip_info_t* chips, size_t max_count,
                                   size_t* count) {
  pthread_mutex_lock(&g_mu);
  tpf_status_t st = TPF_OK;
  if (!g.initialized) {
    st = TPF_ERR_NOT_INITIALIZED;
  } else if (!chips || !count) {
    st = TPF_ERR_INVALID_ARG;
  } else {
    size_t n = g.count < max_count ? g.count : max_count;
    for (size_t i = 0; i < n; ++i) fill_chip_info(&g.devices[i], &chips[i]);
    *count = n;
  }
  pthread_mutex_unlock(&g_mu);
  return st;
}

static void classify_link(const device_t* a, const device_t* b, tpf_link_t* l) {
  int status = NV_P2P_STATUS_NOT_SUPPORTED;
  if (nv.nvmlDeviceGetP2PStatus(a->handle, b->handle, NV_P2P_CAPS_INDEX_NVLINK,
                                &status) == NV_SUCCESS &&
      status == NV_P2P_STATUS_OK) {
    l->kind = TPF_LINK_ICI;
    l->hops = 1;
    l->gbps = a->gen->nvlink_gbps;
    return;
  }
  int level = 0;
  l->hops = -1;
  if (nv.nvmlDeviceGetTopologyCommonAncestor(a->handle, b->handle, &level) !=
      NV_SUCCESS) {
    l->kind = TPF_LINK_NONE;
    return;
  }
  l->kind = level >= NV_TOPOLOGY_SYSTEM ? TPF_LINK_DCN : TPF_LINK_ICI_ROUTED;
  l->gbps = PCIE_GBPS;
}

TPF_API tpf_status_t tpf_topology(tpf_topology_t* topology) {
  pthread_mutex_lock(&g_mu);
  if (!g.initialized || !topology) {
    pthread_mutex_unlock(&g_mu);
    return !g.initialized ? TPF_ERR_NOT_INITIALIZED : TPF_ERR_INVALID_ARG;
  }
  memset(topology, 0, sizeof(*topology));
  topology->mesh_shape[0] = (int32_t)g.count;
  topology->mesh_shape[1] = 1;
  topology->mesh_shape[2] = 1;
  topology->row_count = g.count;
  for (size_t i = 0; i < g.count; ++i) {
    const device_t* a = &g.devices[i];
    tpf_topo_row_t* row = &topology->rows[i];
    copy_str(row->chip_id, sizeof(row->chip_id), a->uuid);
    row->index = (int32_t)i;
    row->mesh_x = (int32_t)a->index;
    row->link_count = g.count;
    for (size_t j = 0; j < g.count; ++j) {
      tpf_link_t* l = &row->links[j];
      copy_str(l->peer_chip_id, sizeof(l->peer_chip_id), g.devices[j].uuid);
      l->peer_index = (int32_t)j;
      if (i == j) {
        l->kind = TPF_LINK_SELF;
        l->hops = 0;
        continue;
      }
      classify_link(a, &g.devices[j], l);
    }
  }
  pthread_mutex_unlock(&g_mu);
  return TPF_OK;
}

/* ---- partitions: the whole card ------------------------------------------- */

static void template_id(const device_t* d, char* out, size_t n) {
  snprintf(out, n, "%s-full", d->gen->gen);
}

TPF_API tpf_status_t tpf_partition_templates(const char* chip_id,
                                             tpf_partition_template_t* out,
                                             size_t max_count, size_t* count) {
  pthread_mutex_lock(&g_mu);
  tpf_status_t st = TPF_OK;
  int idx;
  if (!g.initialized) {
    st = TPF_ERR_NOT_INITIALIZED;
  } else if (!chip_id || !out || !count) {
    st = TPF_ERR_INVALID_ARG;
  } else if ((idx = find_device_locked(chip_id)) < 0) {
    st = TPF_ERR_NOT_FOUND;
  } else {
    const device_t* d = &g.devices[idx];
    *count = 0;
    if (max_count >= 1) {
      tpf_partition_template_t* t = &out[0];
      memset(t, 0, sizeof(*t));
      template_id(d, t->template_id, sizeof(t->template_id));
      snprintf(t->name, sizeof(t->name), "%s whole card", d->name);
      t->core_count = 1;
      t->hbm_bytes = d->hbm_bytes;
      t->bf16_tflops = d->gen->bf16_tflops;
      t->slots = 1;
      t->is_default = 1;
      *count = 1;
    }
  }
  pthread_mutex_unlock(&g_mu);
  return st;
}

TPF_API tpf_status_t tpf_partition_create(const char* template_id_arg,
                                          const char* chip_id,
                                          tpf_partition_grant_t* grant) {
  pthread_mutex_lock(&g_mu);
  tpf_status_t st = TPF_OK;
  int idx = -1;
  char tmpl[TPF_ID_LEN];
  if (!g.initialized) {
    st = TPF_ERR_NOT_INITIALIZED;
  } else if (!template_id_arg || !chip_id || !grant) {
    st = TPF_ERR_INVALID_ARG;
  } else if ((idx = find_device_locked(chip_id)) < 0) {
    st = TPF_ERR_NOT_FOUND;
  } else {
    device_t* d = &g.devices[idx];
    template_id(d, tmpl, sizeof(tmpl));
    if (strcmp(tmpl, template_id_arg) != 0) {
      st = TPF_ERR_INVALID_ARG;
    } else if (d->partition_id[0]) {
      st = TPF_ERR_EXHAUSTED;
    } else {
      char id[TPF_ID_LEN];
      snprintf(id, sizeof(id), "%.40s-p%zu", d->uuid, d->next_partition_seq++);
      copy_str(d->partition_id, sizeof(d->partition_id), id);
      memset(grant, 0, sizeof(*grant));
      grant->kind = TPF_GRANT_ENV;
      copy_str(grant->chip_id, sizeof(grant->chip_id), d->uuid);
      copy_str(grant->partition_id, sizeof(grant->partition_id), d->partition_id);
      snprintf(grant->env[0], TPF_ENV_LEN, "CUDA_VISIBLE_DEVICES=%s", d->uuid);
      snprintf(grant->env[1], TPF_ENV_LEN, "TPF_PARTITION_ID=%s", d->partition_id);
      snprintf(grant->env[2], TPF_ENV_LEN, "TPF_PARTITION_HBM_BYTES=%llu",
               (unsigned long long)d->hbm_bytes);
      grant->env_count = 3;
    }
  }
  pthread_mutex_unlock(&g_mu);
  return st;
}

TPF_API tpf_status_t tpf_partition_destroy(const char* template_or_partition_id,
                                           const char* chip_id) {
  pthread_mutex_lock(&g_mu);
  tpf_status_t st = TPF_OK;
  int idx;
  char tmpl[TPF_ID_LEN];
  if (!g.initialized) {
    st = TPF_ERR_NOT_INITIALIZED;
  } else if (!template_or_partition_id || !chip_id) {
    st = TPF_ERR_INVALID_ARG;
  } else if ((idx = find_device_locked(chip_id)) < 0) {
    st = TPF_ERR_NOT_FOUND;
  } else {
    device_t* d = &g.devices[idx];
    template_id(d, tmpl, sizeof(tmpl));
    if (d->partition_id[0] &&
        (strcmp(d->partition_id, template_or_partition_id) == 0 ||
         strcmp(tmpl, template_or_partition_id) == 0))
      d->partition_id[0] = '\0';
    else
      st = TPF_ERR_NOT_FOUND;
  }
  pthread_mutex_unlock(&g_mu);
  return st;
}

/* ---- hard limits (recorded, not enforced: header comment) ----------------- */

TPF_API tpf_status_t tpf_set_hbm_hard_limit(const char* chip_id,
                                            uint64_t limit_bytes) {
  pthread_mutex_lock(&g_mu);
  tpf_status_t st = TPF_OK;
  int idx;
  if (!g.initialized) st = TPF_ERR_NOT_INITIALIZED;
  else if (!chip_id) st = TPF_ERR_INVALID_ARG;
  else if ((idx = find_device_locked(chip_id)) < 0) st = TPF_ERR_NOT_FOUND;
  else g.devices[idx].hbm_hard_limit = limit_bytes;
  pthread_mutex_unlock(&g_mu);
  return st;
}

TPF_API tpf_status_t tpf_set_duty_hard_limit(const char* chip_id,
                                             uint32_t duty_pct) {
  pthread_mutex_lock(&g_mu);
  tpf_status_t st = TPF_OK;
  int idx;
  if (!g.initialized) st = TPF_ERR_NOT_INITIALIZED;
  else if (!chip_id || duty_pct > 100) st = TPF_ERR_INVALID_ARG;
  else if ((idx = find_device_locked(chip_id)) < 0) st = TPF_ERR_NOT_FOUND;
  else g.devices[idx].duty_hard_limit = duty_pct;
  pthread_mutex_unlock(&g_mu);
  return st;
}

/* ---- snapshot / restore (manifest + freeze, as the PJRT provider) --------- */

static void snapshot_path(const tpf_snapshot_ctx_t* ctx, char* out, size_t n) {
  snprintf(out, n, "%s/%s.tpfsnap", ctx->state_dir,
           ctx->chip_id ? ctx->chip_id : "procs");
}

TPF_API tpf_status_t tpf_snapshot(const tpf_snapshot_ctx_t* ctx) {
  pthread_mutex_lock(&g_mu);
  tpf_status_t st = TPF_OK;
  int idx = -1;
  char path[TPF_PATH_LEN];
  FILE* f = NULL;
  if (!g.initialized) {
    st = TPF_ERR_NOT_INITIALIZED;
  } else if (!ctx || !ctx->state_dir || (!ctx->chip_id && ctx->pid_count == 0)) {
    st = TPF_ERR_INVALID_ARG;
  } else if (ctx->chip_id && (idx = find_device_locked(ctx->chip_id)) < 0) {
    st = TPF_ERR_NOT_FOUND;
  } else {
    snapshot_path(ctx, path, sizeof(path));
    f = fopen(path, "w");
    if (!f) st = TPF_ERR_FAILED;
  }
  if (f && idx >= 0) {
    device_t* d = &g.devices[idx];
    d->frozen = 1;  /* metrics expose it; the worker controller quiesces */
    nv_memory_t mem;
    memset(&mem, 0, sizeof(mem));
    nv.nvmlDeviceGetMemoryInfo(d->handle, &mem);
    fprintf(f, "chip %s\n", d->uuid);
    fprintf(f, "kind %s\n", d->name);
    fprintf(f, "index %u\n", d->index);
    fprintf(f, "hbm_in_use %llu\n", mem.used);
    fprintf(f, "hbm_limit %llu\n", mem.total);
    fprintf(f, "partition_seq %zu\n", d->next_partition_seq);
    if (d->partition_id[0]) {
      char tmpl[TPF_ID_LEN];
      template_id(d, tmpl, sizeof(tmpl));
      fprintf(f, "partition %s %s 0 1\n", d->partition_id, tmpl);
    }
  } else if (f) {
    for (size_t i = 0; i < ctx->pid_count; ++i)
      fprintf(f, "pid %lld\n", (long long)ctx->pids[i]);
  }
  if (f) fclose(f);
  pthread_mutex_unlock(&g_mu);
  return st;
}

TPF_API tpf_status_t tpf_restore(const tpf_snapshot_ctx_t* ctx) {
  pthread_mutex_lock(&g_mu);
  tpf_status_t st = TPF_OK;
  int idx = -1;
  char path[TPF_PATH_LEN];
  FILE* f = NULL;
  if (!g.initialized) {
    st = TPF_ERR_NOT_INITIALIZED;
  } else if (!ctx || !ctx->state_dir) {
    st = TPF_ERR_INVALID_ARG;
  } else {
    snapshot_path(ctx, path, sizeof(path));
    f = fopen(path, "r");
    if (!f) st = TPF_ERR_NOT_FOUND;
    else if (ctx->chip_id && (idx = find_device_locked(ctx->chip_id)) < 0)
      st = TPF_ERR_NOT_FOUND;
  }
  if (f && idx >= 0) {
    /* re-adopt the manifest's partition (hypervisor restart recovery) */
    device_t* d = &g.devices[idx];
    char line[640], part[TPF_ID_LEN], tmpl[TPF_ID_LEN];
    size_t seq = 0;
    while (fgets(line, sizeof(line), f)) {
      if (sscanf(line, "partition_seq %zu", &seq) == 1) {
        /* restore the id counter too, or fresh creates after a restart
         * would mint ids colliding with the re-adopted partition */
        if (seq > d->next_partition_seq) d->next_partition_seq = seq;
      } else if (sscanf(line, "partition %63s %63s", part, tmpl) == 2) {
        copy_str(d->partition_id, sizeof(d->partition_id), part);
      }
    }
    d->frozen = 0;
  }
  if (f) fclose(f);
  pthread_mutex_unlock(&g_mu);
  return st;
}

/* ---- metrics -------------------------------------------------------------- */

static void put_extra(tpf_chip_metrics_t* m, const char* key, double value) {
  if (m->extra_count >= TPF_MAX_EXTRA_METRICS) return;
  copy_str(m->extra[m->extra_count].key, TPF_ID_LEN, key);
  m->extra[m->extra_count++].value = value;
}

TPF_API tpf_status_t tpf_chip_metrics(const char** chip_ids, size_t chip_count,
                                      tpf_chip_metrics_t* out) {
  pthread_mutex_lock(&g_mu);
  if (!g.initialized || !chip_ids || !out) {
    pthread_mutex_unlock(&g_mu);
    return !g.initialized ? TPF_ERR_NOT_INITIALIZED : TPF_ERR_INVALID_ARG;
  }
  for (size_t i = 0; i < chip_count; ++i) {
    tpf_chip_metrics_t* m = &out[i];
    memset(m, 0, sizeof(*m));
    if (!chip_ids[i]) continue;
    copy_str(m->chip_id, sizeof(m->chip_id), chip_ids[i]);
    int idx = find_device_locked(chip_ids[i]);
    if (idx < 0) continue;
    const device_t* d = &g.devices[idx];
    nv_utilization_t util;
    if (nv.nvmlDeviceGetUtilizationRates(d->handle, &util) == NV_SUCCESS) {
      m->duty_cycle_pct = util.gpu;
      m->hbm_bw_util_pct = util.memory;
    }
    nv_memory_t mem;
    if (nv.nvmlDeviceGetMemoryInfo(d->handle, &mem) == NV_SUCCESS)
      m->hbm_used_bytes = mem.used;
    unsigned int value = 0;
    if (nv.nvmlDeviceGetPowerUsage(d->handle, &value) == NV_SUCCESS)
      m->power_watts = value / 1000.0;
    if (nv.nvmlDeviceGetTemperature(d->handle, NV_TEMPERATURE_GPU, &value) ==
        NV_SUCCESS)
      m->temp_celsius = value;
    if (nv.nvmlDeviceGetPowerManagementLimit(d->handle, &value) == NV_SUCCESS)
      put_extra(m, "power_limit_w", value / 1000.0);
    put_extra(m, "hbm_hard_limit_bytes", (double)d->hbm_hard_limit);
    put_extra(m, "duty_hard_limit_pct", (double)d->duty_hard_limit);
    put_extra(m, "frozen", d->frozen ? 1.0 : 0.0);
    put_extra(m, "proc_util_supported", g.proc_util_supported ? 1.0 : 0.0);
  }
  pthread_mutex_unlock(&g_mu);
  return TPF_OK;
}

/* The compute processes on one card: fills *infos (malloc'd) and *n. */
static nv_return_t running_processes(const device_t* d, nv_process_info_t** infos,
                                     unsigned int* n) {
  unsigned int cap = 64;
  for (;;) {
    *infos = calloc(cap, sizeof(**infos));
    if (!*infos) return NV_ERROR_INSUFFICIENT_SIZE;
    *n = cap;
    nv_return_t rc = nv.nvmlDeviceGetComputeRunningProcesses_v3(d->handle, n, *infos);
    if (rc != NV_ERROR_INSUFFICIENT_SIZE || *n <= cap) return rc;
    free(*infos);
    *infos = NULL;
    cap = *n + 16;  /* processes may start between the two calls */
  }
}

/* The utilization samples newer than the device's last read: fills
 * *samples (malloc'd, or NULL when there is none) and *n. */
static void utilization_samples(device_t* d, nv_process_utilization_sample_t** samples,
                                unsigned int* n) {
  *samples = NULL;
  *n = 0;
  if (!g.proc_util_supported) return;
  *samples = calloc(MAX_SAMPLES, sizeof(**samples));
  if (!*samples) return;
  unsigned int got = MAX_SAMPLES;
  nv_return_t rc = nv.nvmlDeviceGetProcessUtilization(d->handle, *samples, &got,
                                                      d->last_seen_ts);
  if (rc != NV_SUCCESS) {
    /* NOT_FOUND: no sample since the last read, which is 0% */
    if (rc == NV_ERROR_NOT_SUPPORTED) {
      g.proc_util_supported = 0;
      logf_("warn", "NVML gives no per-process utilization (%s): "
            "process duty is reported as 0", nv_error(rc));
    } else if (rc != NV_ERROR_NOT_FOUND) {
      logf_("warn", "nvmlDeviceGetProcessUtilization(GPU %u) failed: %s",
            d->index, nv_error(rc));
    }
    free(*samples);
    *samples = NULL;
    return;
  }
  *n = got < MAX_SAMPLES ? got : MAX_SAMPLES;
  for (unsigned int k = 0; k < *n; ++k)
    if ((*samples)[k].timeStamp > d->last_seen_ts)
      d->last_seen_ts = (*samples)[k].timeStamp;
}

TPF_API tpf_status_t tpf_proc_stats(tpf_proc_stats_t* out, size_t max_count,
                                    size_t* count) {
  pthread_mutex_lock(&g_mu);
  if (!g.initialized || !count || (!out && max_count > 0)) {
    pthread_mutex_unlock(&g_mu);
    return !g.initialized ? TPF_ERR_NOT_INITIALIZED : TPF_ERR_INVALID_ARG;
  }
  size_t n = 0;
  tpf_status_t st = TPF_OK;
  for (size_t i = 0; i < g.count && n < max_count; ++i) {
    device_t* d = &g.devices[i];
    nv_process_info_t* procs = NULL;
    unsigned int np = 0;
    nv_return_t rc = running_processes(d, &procs, &np);
    if (rc != NV_SUCCESS) {
      logf_("error", "nvmlDeviceGetComputeRunningProcesses_v3(GPU %u) failed: %s",
            d->index, nv_error(rc));
      free(procs);
      st = TPF_ERR_FAILED;
      break;
    }
    nv_process_utilization_sample_t* samples = NULL;
    unsigned int ns = 0;
    utilization_samples(d, &samples, &ns);
    for (unsigned int p = 0; p < np && n < max_count; ++p) {
      double sum = 0.0;
      unsigned int hits = 0;
      for (unsigned int k = 0; k < ns; ++k) {
        if (samples[k].pid == procs[p].pid) {
          sum += samples[k].smUtil;
          ++hits;
        }
      }
      tpf_proc_stats_t* s = &out[n++];
      memset(s, 0, sizeof(*s));
      s->pid = procs[p].pid;
      copy_str(s->chip_id, sizeof(s->chip_id), d->uuid);
      s->duty_cycle_pct = hits ? sum / hits : 0.0;
      s->hbm_used_bytes = procs[p].usedGpuMemory == NV_VALUE_NOT_AVAILABLE
                              ? 0 : procs[p].usedGpuMemory;
    }
    free(samples);
    free(procs);
  }
  *count = n;
  pthread_mutex_unlock(&g_mu);
  return st;
}

/* ---- mounts: the control nodes every CUDA process needs ------------------- */

TPF_API tpf_status_t tpf_mounts(tpf_mount_t* out, size_t max_count, size_t* count) {
  static const char* kNodes[] = {"/dev/nvidiactl", "/dev/nvidia-uvm"};
  const size_t n = sizeof(kNodes) / sizeof(kNodes[0]);
  pthread_mutex_lock(&g_mu);
  tpf_status_t st = TPF_OK;
  if (!g.initialized) {
    st = TPF_ERR_NOT_INITIALIZED;
  } else if (!out || !count || max_count < n) {
    st = TPF_ERR_INVALID_ARG;
  } else {
    for (size_t i = 0; i < n; ++i) {
      copy_str(out[i].host_path, sizeof(out[i].host_path), kNodes[i]);
      copy_str(out[i].guest_path, sizeof(out[i].guest_path), kNodes[i]);
    }
    *count = n;
  }
  pthread_mutex_unlock(&g_mu);
  return st;
}
