/*
 * A stand-in for libnvidia-ml.so.1 that exports only the symbols the NVML
 * provider (provider_nvml.c) resolves, so the provider can be tested on a
 * machine without a GPU (the counterpart of
 * native/pjrt_proxy/fake_pjrt_plugin.cc).  Built only by the tests:
 *
 *   cc -std=c11 -O2 -shared -fPIC fake_nvml.c -o libnvidia-ml.so.1
 *   TPF_NVML_LIB=$PWD/libnvidia-ml.so.1 <run the provider>
 *
 * Compiled with -DFAKE_NVML_OMIT_UUID it lacks nvmlDeviceGetUUID (the
 * missing-symbol case).  What it reports is set by environment variables,
 * read at nvmlInit_v2 (devices) or at each call (processes).  Init and
 * shutdown are reference counted, as NVML's are:
 *
 *   TPF_FAKE_NVML_FAIL_INIT=1     nvmlInit_v2 returns DRIVER_NOT_LOADED
 *   TPF_FAKE_NVML_COUNT=n         cards (default 1, at most 16)
 *   TPF_FAKE_NVML_NAME=...        every card's name ("NVIDIA H100 80GB HBM3")
 *   TPF_FAKE_NVML_MEMORY=bytes    every card's memory (85520809984)
 *   TPF_FAKE_NVML_NVLINK=0-1,2-3  NVLink pairs
 *   TPF_FAKE_NVML_NUMA=0,0,1,1    NUMA node of each card (default 0): the
 *                                 common ancestor of two cards is a host
 *                                 bridge on one node, "system" across nodes
 *   TPF_FAKE_NVML_UNSUPPORTED=pci,topology,process_utilization
 *                                 calls that return NOT_SUPPORTED
 *   TPF_FAKE_NVML_PROCS=pid:card:bytes:sm@ts/sm@ts;...
 *                                 compute processes, each with its memory
 *                                 and its utilization samples (smUtil at a
 *                                 timestamp in microseconds)
 *
 * Card i has the UUID GPU-00000000-0000-0000-0000-0000000000<i>, PCI bus
 * 0x10 + i, minor number i, 37% duty, 12% memory-bandwidth use, 312.5 W of
 * a 700 W limit and 41 C; its used memory is the sum of its processes'.
 */

#define _GNU_SOURCE
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "nvml_types.h"

#define FAKE_API __attribute__((visibility("default")))
#define MAX_CARDS 16
#define MAX_PROCS 64
#define MAX_SAMPLES_PER_PROC 16

typedef struct {
  unsigned int pid;
  unsigned int card;
  unsigned long long bytes;
  unsigned int n_samples;
  unsigned int sm[MAX_SAMPLES_PER_PROC];
  unsigned long long ts[MAX_SAMPLES_PER_PROC];
} fake_proc_t;

static struct {
  int initialized;               /* nvmlInit_v2 calls not yet shut down */
  unsigned int count;
  char name[NV_DEVICE_NAME_BUFFER_SIZE];
  unsigned long long memory;
  int numa[MAX_CARDS];
  int nvlink[MAX_CARDS][MAX_CARDS];
} g;

/* a handle is a pointer into this array */
static unsigned int g_handles[MAX_CARDS];

static int card_of(nv_device_t d, unsigned int* card) {
  unsigned int* p = (unsigned int*)d;
  if (!g.initialized || p < g_handles || p >= g_handles + g.count) return 0;
  *card = *p;
  return 1;
}

static int unsupported(const char* call) {
  const char* list = getenv("TPF_FAKE_NVML_UNSUPPORTED");
  if (!list) return 0;
  size_t n = strlen(call);
  for (const char* p = strstr(list, call); p; p = strstr(p + 1, call))
    if ((p == list || p[-1] == ',') && (p[n] == '\0' || p[n] == ','))
      return 1;
  return 0;
}

/* parses TPF_FAKE_NVML_PROCS; returns the number of processes */
static unsigned int read_procs(fake_proc_t* out) {
  const char* env = getenv("TPF_FAKE_NVML_PROCS");
  if (!env || !*env) return 0;
  char* copy = strdup(env);
  unsigned int n = 0;
  char* save = NULL;
  for (char* item = strtok_r(copy, ";", &save); item && n < MAX_PROCS;
       item = strtok_r(NULL, ";", &save)) {
    fake_proc_t* p = &out[n];
    memset(p, 0, sizeof(*p));
    char samples[512] = {0};
    if (sscanf(item, "%u:%u:%llu:%511s", &p->pid, &p->card, &p->bytes, samples) < 3)
      continue;
    char* save2 = NULL;
    for (char* s = strtok_r(samples, "/", &save2);
         s && p->n_samples < MAX_SAMPLES_PER_PROC; s = strtok_r(NULL, "/", &save2)) {
      if (sscanf(s, "%u@%llu", &p->sm[p->n_samples], &p->ts[p->n_samples]) == 2)
        ++p->n_samples;
    }
    ++n;
  }
  free(copy);
  return n;
}

FAKE_API nv_return_t nvmlInit_v2(void) {
  const char* fail = getenv("TPF_FAKE_NVML_FAIL_INIT");
  if (fail && *fail == '1') return NV_ERROR_DRIVER_NOT_LOADED;
  int refs = g.initialized;
  memset(&g, 0, sizeof(g));
  const char* env = getenv("TPF_FAKE_NVML_COUNT");
  g.count = env ? (unsigned int)atoi(env) : 1;
  if (g.count > MAX_CARDS) g.count = MAX_CARDS;
  env = getenv("TPF_FAKE_NVML_NAME");
  snprintf(g.name, sizeof(g.name), "%s", env ? env : "NVIDIA H100 80GB HBM3");
  env = getenv("TPF_FAKE_NVML_MEMORY");
  g.memory = env ? strtoull(env, NULL, 10) : 85520809984ull;
  env = getenv("TPF_FAKE_NVML_NUMA");
  for (unsigned int i = 0; env && *env && i < MAX_CARDS; ++i) {
    g.numa[i] = atoi(env);
    env = strchr(env, ',');
    if (env) ++env;
  }
  env = getenv("TPF_FAKE_NVML_NVLINK");
  while (env && *env) {
    unsigned int a, b;
    if (sscanf(env, "%u-%u", &a, &b) == 2 && a < MAX_CARDS && b < MAX_CARDS)
      g.nvlink[a][b] = g.nvlink[b][a] = 1;
    env = strchr(env, ',');
    if (env) ++env;
  }
  for (unsigned int i = 0; i < MAX_CARDS; ++i) g_handles[i] = i;
  g.initialized = refs + 1;
  return NV_SUCCESS;
}

FAKE_API nv_return_t nvmlShutdown(void) {
  if (g.initialized > 0) --g.initialized;
  return NV_SUCCESS;
}

FAKE_API const char* nvmlErrorString(nv_return_t rc) {
  switch (rc) {
    case NV_SUCCESS: return "Success";
    case NV_ERROR_NOT_SUPPORTED: return "Not Supported";
    case NV_ERROR_NOT_FOUND: return "Not Found";
    case NV_ERROR_INSUFFICIENT_SIZE: return "Insufficient Size";
    case NV_ERROR_DRIVER_NOT_LOADED: return "Driver Not Loaded";
    default: return "Unknown Error";
  }
}

FAKE_API nv_return_t nvmlSystemGetDriverVersion(char* out, unsigned int n) {
  snprintf(out, n, "580.00.fake");
  return NV_SUCCESS;
}

FAKE_API nv_return_t nvmlDeviceGetCount_v2(unsigned int* count) {
  *count = g.count;
  return NV_SUCCESS;
}

FAKE_API nv_return_t nvmlDeviceGetHandleByIndex_v2(unsigned int i, nv_device_t* d) {
  if (i >= g.count) return NV_ERROR_NOT_FOUND;
  *d = &g_handles[i];
  return NV_SUCCESS;
}

FAKE_API nv_return_t nvmlDeviceGetName(nv_device_t d, char* out, unsigned int n) {
  unsigned int c;
  if (!card_of(d, &c)) return NV_ERROR_NOT_FOUND;
  snprintf(out, n, "%s", g.name);
  return NV_SUCCESS;
}

#ifndef FAKE_NVML_OMIT_UUID
FAKE_API nv_return_t nvmlDeviceGetUUID(nv_device_t d, char* out, unsigned int n) {
  unsigned int c;
  if (!card_of(d, &c)) return NV_ERROR_NOT_FOUND;
  snprintf(out, n, "GPU-00000000-0000-0000-0000-0000000000%02u", c);
  return NV_SUCCESS;
}
#endif

FAKE_API nv_return_t nvmlDeviceGetMinorNumber(nv_device_t d, unsigned int* minor) {
  return card_of(d, minor) ? NV_SUCCESS : NV_ERROR_NOT_FOUND;
}

FAKE_API nv_return_t nvmlDeviceGetPciInfo_v3(nv_device_t d, nv_pci_info_t* pci) {
  unsigned int c;
  if (!card_of(d, &c)) return NV_ERROR_NOT_FOUND;
  if (unsupported("pci")) return NV_ERROR_NOT_SUPPORTED;
  memset(pci, 0, sizeof(*pci));
  pci->domain = 0;
  pci->bus = 0x10 + c;
  pci->device = 0;
  snprintf(pci->busId, sizeof(pci->busId), "00000000:%02X:00.0", pci->bus);
  snprintf(pci->busIdLegacy, sizeof(pci->busIdLegacy), "0000:%02X:00.0", pci->bus);
  return NV_SUCCESS;
}

static unsigned long long used_bytes(unsigned int card) {
  fake_proc_t procs[MAX_PROCS];
  unsigned int n = read_procs(procs);
  unsigned long long used = 0;
  for (unsigned int i = 0; i < n; ++i)
    if (procs[i].card == card) used += procs[i].bytes;
  return used;
}

FAKE_API nv_return_t nvmlDeviceGetMemoryInfo(nv_device_t d, nv_memory_t* mem) {
  unsigned int c;
  if (!card_of(d, &c)) return NV_ERROR_NOT_FOUND;
  mem->total = g.memory;
  mem->used = used_bytes(c);
  mem->free = mem->total - mem->used;
  return NV_SUCCESS;
}

FAKE_API nv_return_t nvmlDeviceGetTopologyCommonAncestor(nv_device_t a, nv_device_t b,
                                                         int* level) {
  unsigned int ca, cb;
  if (!card_of(a, &ca) || !card_of(b, &cb)) return NV_ERROR_NOT_FOUND;
  if (unsupported("topology")) return NV_ERROR_NOT_SUPPORTED;
  *level = ca == cb ? NV_TOPOLOGY_INTERNAL
           : g.numa[ca] == g.numa[cb] ? NV_TOPOLOGY_HOSTBRIDGE : NV_TOPOLOGY_SYSTEM;
  return NV_SUCCESS;
}

FAKE_API nv_return_t nvmlDeviceGetP2PStatus(nv_device_t a, nv_device_t b, int index,
                                            int* status) {
  unsigned int ca, cb;
  if (!card_of(a, &ca) || !card_of(b, &cb)) return NV_ERROR_NOT_FOUND;
  *status = index == NV_P2P_CAPS_INDEX_NVLINK && g.nvlink[ca][cb]
                ? NV_P2P_STATUS_OK : NV_P2P_STATUS_NOT_SUPPORTED;
  return NV_SUCCESS;
}

FAKE_API nv_return_t nvmlDeviceGetUtilizationRates(nv_device_t d, nv_utilization_t* u) {
  unsigned int c;
  if (!card_of(d, &c)) return NV_ERROR_NOT_FOUND;
  u->gpu = 37;
  u->memory = 12;
  return NV_SUCCESS;
}

FAKE_API nv_return_t nvmlDeviceGetPowerUsage(nv_device_t d, unsigned int* mw) {
  unsigned int c;
  if (!card_of(d, &c)) return NV_ERROR_NOT_FOUND;
  *mw = 312500;
  return NV_SUCCESS;
}

FAKE_API nv_return_t nvmlDeviceGetPowerManagementLimit(nv_device_t d, unsigned int* mw) {
  unsigned int c;
  if (!card_of(d, &c)) return NV_ERROR_NOT_FOUND;
  *mw = 700000;
  return NV_SUCCESS;
}

FAKE_API nv_return_t nvmlDeviceGetTemperature(nv_device_t d, int sensor, unsigned int* t) {
  unsigned int c;
  if (!card_of(d, &c) || sensor != NV_TEMPERATURE_GPU) return NV_ERROR_NOT_FOUND;
  *t = 41;
  return NV_SUCCESS;
}

FAKE_API nv_return_t nvmlDeviceGetComputeRunningProcesses_v3(nv_device_t d,
                                                             unsigned int* count,
                                                             nv_process_info_t* infos) {
  unsigned int c;
  if (!card_of(d, &c)) return NV_ERROR_NOT_FOUND;
  fake_proc_t procs[MAX_PROCS];
  unsigned int n = read_procs(procs), m = 0;
  for (unsigned int i = 0; i < n; ++i) m += procs[i].card == c;
  if (*count < m) {
    *count = m;
    return NV_ERROR_INSUFFICIENT_SIZE;
  }
  m = 0;
  for (unsigned int i = 0; i < n; ++i) {
    if (procs[i].card != c) continue;
    infos[m].pid = procs[i].pid;
    infos[m].usedGpuMemory = procs[i].bytes;
    infos[m].gpuInstanceId = infos[m].computeInstanceId = 0xFFFFFFFFu;
    ++m;
  }
  *count = m;
  return NV_SUCCESS;
}

FAKE_API nv_return_t nvmlDeviceGetProcessUtilization(
    nv_device_t d, nv_process_utilization_sample_t* out, unsigned int* count,
    unsigned long long last_seen) {
  unsigned int c;
  if (!card_of(d, &c)) return NV_ERROR_NOT_FOUND;
  if (unsupported("process_utilization")) return NV_ERROR_NOT_SUPPORTED;
  fake_proc_t procs[MAX_PROCS];
  unsigned int n = read_procs(procs), m = 0;
  for (unsigned int i = 0; i < n; ++i)
    for (unsigned int k = 0; k < procs[i].n_samples; ++k)
      m += procs[i].card == c && procs[i].ts[k] > last_seen;
  if (m == 0) return NV_ERROR_NOT_FOUND;
  if (!out || *count < m) {
    *count = m;
    return NV_ERROR_INSUFFICIENT_SIZE;
  }
  m = 0;
  for (unsigned int i = 0; i < n; ++i) {
    for (unsigned int k = 0; k < procs[i].n_samples; ++k) {
      if (procs[i].card != c || procs[i].ts[k] <= last_seen) continue;
      memset(&out[m], 0, sizeof(out[m]));
      out[m].pid = procs[i].pid;
      out[m].timeStamp = procs[i].ts[k];
      out[m].smUtil = procs[i].sm[k];
      ++m;
    }
  }
  *count = m;
  return NV_SUCCESS;
}
