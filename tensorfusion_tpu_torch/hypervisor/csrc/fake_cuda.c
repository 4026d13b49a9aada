/*
 * A stand-in for libcuda.so.1 that exports only what the launch and memory
 * hook (cuda_hook.c) and its selftest reach, so the hook can be tested on
 * a machine without a GPU (the counterpart of
 * native/pjrt_proxy/fake_pjrt_plugin.cc).  Built only by the tests:
 *
 *   cc -std=c11 -O2 -shared -fPIC fake_cuda.c -o libcuda.so.1
 *   LD_LIBRARY_PATH=$PWD LD_PRELOAD=libtpf_cuda_hook.so <run the selftest>
 *
 * It answers cuGetProcAddress(_v2) from its own table (the _ptsz variant
 * for a per-thread query, the _v2 ABI for versions that have one), counts
 * every call that reaches it (tpf_fake_cuda_count), and keeps a device
 * clock: every kernel launch advances it by TPF_FAKE_CUDA_LAUNCH_US
 * (default 100), every graph launch by TPF_FAKE_CUDA_GRAPH_US (default
 * 1000).  An event records the clock and the launch count; it completes
 * once TPF_FAKE_CUDA_LAG (default 0) more launches have been made, or a
 * synchronize has been made since, and the elapsed time of two events is
 * the clock between them; a stream is idle (cuStreamQuery) on the same
 * terms for its last launch.  With TPF_FAKE_CUDA_CLOCK=host an event
 * records the host's CLOCK_MONOTONIC instead (in microseconds), so the
 * windows of processes that launch at the same time overlap as they would
 * on one card.  tpf_fake_cuda_drain() completes everything
 * as a synchronize does, without a call any hook sees.  A stream is
 * capturing between cuStreamBeginCapture and cuStreamEndCapture, and
 * launches on it advance nothing; cuStreamDestroy is only counted.  Allocations hand out increasing
 * addresses and handles.  The variables are read at each call.
 */

#define _GNU_SOURCE
#include <pthread.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

#include "cuda_types.h"

#define FAKE_API __attribute__((visibility("default")))
#define MAX_CAPTURING 16
#define MAX_STREAMS 64

typedef struct cu_event_st {
  uint64_t clock_us;
  uint64_t seq;
  int recorded;
} fake_event_t;

static struct {
  pthread_mutex_t mu;
  uint64_t clock_us;         /* the device clock */
  uint64_t seq;              /* kernel and graph launches run */
  uint64_t next_ptr;
  uint64_t next_handle;
  uint64_t synced_seq;       /* everything up to it has completed */
  cu_stream_t capturing[MAX_CAPTURING];
  cu_stream_t streams[MAX_STREAMS];
  uint64_t stream_seq[MAX_STREAMS];   /* each stream's last launch */
  /* counts */
  uint64_t launches, graph_launches, captured_launches, allocs, frees, creates, releases,
      event_records, capture_event_records, syncs, stream_destroys;
} g = {.mu = PTHREAD_MUTEX_INITIALIZER, .next_ptr = 0x7f0000000000ull, .next_handle = 1};

static uint64_t env_u64(const char* name, uint64_t fallback) {
  const char* s = getenv(name);
  return (s && *s) ? strtoull(s, NULL, 10) : fallback;
}

static int capturing_locked(cu_stream_t s) {
  for (int i = 0; i < MAX_CAPTURING; ++i)
    if (s && g.capturing[i] == s) return 1;
  return 0;
}

static int complete_locked(uint64_t seq) {
  return seq <= g.synced_seq || g.seq >= seq + env_u64("TPF_FAKE_CUDA_LAG", 0);
}

static uint64_t* stream_seq_locked(cu_stream_t s) {
  for (int i = 0; i < MAX_STREAMS; ++i)
    if (g.streams[i] == s || !g.streams[i]) {
      g.streams[i] = s;
      return &g.stream_seq[i];
    }
  return NULL;
}

static cu_result_t run(cu_stream_t s, uint64_t us, uint64_t* count) {
  pthread_mutex_lock(&g.mu);
  if (capturing_locked(s)) {
    g.captured_launches++;
  } else {
    g.clock_us += us;
    g.seq++;
    (*count)++;
    uint64_t* last = stream_seq_locked(s);
    if (last) *last = g.seq;
  }
  pthread_mutex_unlock(&g.mu);
  return CU__SUCCESS;
}

#define LAUNCH_US env_u64("TPF_FAKE_CUDA_LAUNCH_US", 100)

/* -- launches ------------------------------------------------------------ */

#define DEFINE_LAUNCHES(SUFFIX)                                                          \
  FAKE_API cu_result_t cuLaunchKernel##SUFFIX(cu_function_t f, unsigned gx, unsigned gy, \
                                              unsigned gz, unsigned bx, unsigned by,     \
                                              unsigned bz, unsigned smem, cu_stream_t s, \
                                              void** p, void** x) {                      \
    (void)f, (void)gx, (void)gy, (void)gz, (void)bx, (void)by, (void)bz, (void)smem;     \
    (void)p, (void)x;                                                                    \
    return run(s, LAUNCH_US, &g.launches);                                               \
  }                                                                                      \
  FAKE_API cu_result_t cuLaunchKernelEx##SUFFIX(const cu_launch_config_t* c,             \
                                                cu_function_t f, void** p, void** x) {   \
    (void)f, (void)p, (void)x;                                                           \
    if (!c) return CU__ERROR_INVALID_VALUE;                                              \
    return run(c->hStream, LAUNCH_US, &g.launches);                                      \
  }                                                                                      \
  FAKE_API cu_result_t cuLaunchCooperativeKernel##SUFFIX(                                \
      cu_function_t f, unsigned gx, unsigned gy, unsigned gz, unsigned bx, unsigned by,  \
      unsigned bz, unsigned smem, cu_stream_t s, void** p) {                             \
    (void)f, (void)gx, (void)gy, (void)gz, (void)bx, (void)by, (void)bz, (void)smem;     \
    (void)p;                                                                             \
    return run(s, LAUNCH_US, &g.launches);                                               \
  }                                                                                      \
  FAKE_API cu_result_t cuGraphLaunch##SUFFIX(cu_graph_exec_t e, cu_stream_t s) {         \
    (void)e;                                                                             \
    return run(s, env_u64("TPF_FAKE_CUDA_GRAPH_US", 1000), &g.graph_launches);           \
  }

DEFINE_LAUNCHES()
DEFINE_LAUNCHES(_ptsz)

/* the same function under a name no hook wraps: the direct path of the
 * selftest's --bench */
FAKE_API cu_result_t tpf_fake_launch_kernel(cu_function_t f, unsigned gx, unsigned gy,
                                            unsigned gz, unsigned bx, unsigned by, unsigned bz,
                                            unsigned smem, cu_stream_t s, void** p, void** x) {
  (void)f, (void)gx, (void)gy, (void)gz, (void)bx, (void)by, (void)bz, (void)smem;
  (void)p, (void)x;
  return run(s, LAUNCH_US, &g.launches);
}

/* -- memory -------------------------------------------------------------- */

/* The exported entries call only these static helpers, never one another:
 * a call between two exports would go through the dynamic linker, to the
 * hook's export of the same name, and be charged twice. */

static uint64_t next_of(uint64_t* counter, uint64_t step) {
  pthread_mutex_lock(&g.mu);
  uint64_t v = *counter;
  *counter += step;
  pthread_mutex_unlock(&g.mu);
  return v;
}

static void count(uint64_t* c) { __atomic_add_fetch(c, 1, __ATOMIC_RELAXED); }

static cu_result_t mem_alloc(cu_deviceptr_t* d, size_t n) {
  if (!d) return CU__ERROR_INVALID_VALUE;
  *d = next_of(&g.next_ptr, (n + 511) & ~(uint64_t)511);
  count(&g.allocs);
  return CU__SUCCESS;
}

static cu_result_t mem_free(cu_deviceptr_t d) {
  (void)d;
  count(&g.frees);
  return CU__SUCCESS;
}

FAKE_API cu_result_t cuMemAlloc_v2(cu_deviceptr_t* d, size_t n) { return mem_alloc(d, n); }

FAKE_API cu_result_t cuMemFree_v2(cu_deviceptr_t d) { return mem_free(d); }

#define DEFINE_ASYNC(SUFFIX)                                                                \
  FAKE_API cu_result_t cuMemAllocAsync##SUFFIX(cu_deviceptr_t* d, size_t n, cu_stream_t s) { \
    (void)s;                                                                                \
    return mem_alloc(d, n);                                                                 \
  }                                                                                         \
  FAKE_API cu_result_t cuMemAllocFromPoolAsync##SUFFIX(cu_deviceptr_t* d, size_t n,         \
                                                       cu_mem_pool_t pool, cu_stream_t s) { \
    (void)pool, (void)s;                                                                    \
    return mem_alloc(d, n);                                                                 \
  }                                                                                         \
  FAKE_API cu_result_t cuMemFreeAsync##SUFFIX(cu_deviceptr_t d, cu_stream_t s) {            \
    (void)s;                                                                                \
    return mem_free(d);                                                                     \
  }

DEFINE_ASYNC()
DEFINE_ASYNC(_ptsz)

FAKE_API cu_result_t cuMemCreate(cu_mem_handle_t* h, size_t n, const cu_mem_allocation_prop_t* p,
                                 unsigned long long flags) {
  (void)n, (void)p, (void)flags;
  if (!h) return CU__ERROR_INVALID_VALUE;
  *h = next_of(&g.next_handle, 1);
  count(&g.creates);
  return CU__SUCCESS;
}

FAKE_API cu_result_t cuMemRelease(cu_mem_handle_t h) {
  (void)h;
  count(&g.releases);
  return CU__SUCCESS;
}

/* -- events and capture -------------------------------------------------- */

FAKE_API cu_result_t cuEventCreate(cu_event_t* e, unsigned int flags) {
  (void)flags;
  if (!e) return CU__ERROR_INVALID_VALUE;
  *e = calloc(1, sizeof(fake_event_t));
  return *e ? CU__SUCCESS : CU__ERROR_INVALID_VALUE;
}

FAKE_API cu_result_t cuEventDestroy_v2(cu_event_t e) {
  free(e);
  return CU__SUCCESS;
}

FAKE_API cu_result_t cuEventRecord(cu_event_t e, cu_stream_t s) {
  if (!e) return CU__ERROR_INVALID_VALUE;
  pthread_mutex_lock(&g.mu);
  if (capturing_locked(s)) g.capture_event_records++;
  e->clock_us = g.clock_us;
  const char* clock = getenv("TPF_FAKE_CUDA_CLOCK");
  if (clock && strcmp(clock, "host") == 0) {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    e->clock_us = (uint64_t)ts.tv_sec * 1000000ull + (uint64_t)ts.tv_nsec / 1000;
  }
  e->seq = g.seq;
  e->recorded = 1;
  g.event_records++;
  pthread_mutex_unlock(&g.mu);
  return CU__SUCCESS;
}

static cu_result_t event_query(cu_event_t e) {
  if (!e) return CU__ERROR_INVALID_VALUE;
  pthread_mutex_lock(&g.mu);
  int done = complete_locked(e->seq);
  pthread_mutex_unlock(&g.mu);
  return done ? CU__SUCCESS : CU__ERROR_NOT_READY;
}

FAKE_API cu_result_t cuEventQuery(cu_event_t e) { return event_query(e); }

FAKE_API cu_result_t cuEventElapsedTime(float* ms, cu_event_t a, cu_event_t b) {
  if (!ms || !a || !b || !a->recorded || !b->recorded) return CU__ERROR_INVALID_VALUE;
  if (event_query(a) != CU__SUCCESS || event_query(b) != CU__SUCCESS)
    return CU__ERROR_NOT_READY;
  *ms = (float)((double)(b->clock_us - a->clock_us) / 1000.0);
  return CU__SUCCESS;
}

FAKE_API cu_result_t cuStreamQuery(cu_stream_t s) {
  pthread_mutex_lock(&g.mu);
  uint64_t* last = stream_seq_locked(s);
  int idle = !last || complete_locked(*last);
  pthread_mutex_unlock(&g.mu);
  return idle ? CU__SUCCESS : CU__ERROR_NOT_READY;
}

static cu_result_t synchronize(void) {
  pthread_mutex_lock(&g.mu);
  g.synced_seq = g.seq;
  g.syncs++;
  pthread_mutex_unlock(&g.mu);
  return CU__SUCCESS;
}

FAKE_API cu_result_t cuCtxSynchronize(void) { return synchronize(); }

FAKE_API cu_result_t cuStreamSynchronize(cu_stream_t s) {
  (void)s;
  return synchronize();
}

FAKE_API cu_result_t cuStreamSynchronize_ptsz(cu_stream_t s) {
  (void)s;
  return synchronize();
}

FAKE_API cu_result_t cuStreamDestroy_v2(cu_stream_t s) {
  if (!s) return CU__ERROR_INVALID_VALUE;
  __atomic_add_fetch(&g.stream_destroys, 1, __ATOMIC_RELAXED);
  return CU__SUCCESS;
}

/* completes everything, as a synchronize would, unseen by any hook */
FAKE_API void tpf_fake_cuda_drain(void) {
  pthread_mutex_lock(&g.mu);
  g.synced_seq = g.seq;
  pthread_mutex_unlock(&g.mu);
}

FAKE_API cu_result_t cuStreamIsCapturing(cu_stream_t s, cu_capture_status_t* st) {
  if (!st) return CU__ERROR_INVALID_VALUE;
  pthread_mutex_lock(&g.mu);
  *st = capturing_locked(s) ? CU__STREAM_CAPTURE_STATUS_ACTIVE : CU__STREAM_CAPTURE_STATUS_NONE;
  pthread_mutex_unlock(&g.mu);
  return CU__SUCCESS;
}

#define DEFINE_CAPTURE(SUFFIX)                                                             \
  FAKE_API cu_result_t cuStreamBeginCapture_v2##SUFFIX(cu_stream_t s, cu_capture_mode_t m) { \
    (void)m;                                                                               \
    if (!s) return CU__ERROR_INVALID_VALUE;                                                \
    pthread_mutex_lock(&g.mu);                                                             \
    int i = 0;                                                                             \
    while (i < MAX_CAPTURING && g.capturing[i]) ++i;                                       \
    if (i < MAX_CAPTURING) g.capturing[i] = s;                                             \
    pthread_mutex_unlock(&g.mu);                                                           \
    return i < MAX_CAPTURING ? CU__SUCCESS : CU__ERROR_INVALID_VALUE;                      \
  }                                                                                        \
  FAKE_API cu_result_t cuStreamEndCapture##SUFFIX(cu_stream_t s, cu_graph_t* graph) {      \
    pthread_mutex_lock(&g.mu);                                                             \
    int found = 0;                                                                         \
    for (int i = 0; i < MAX_CAPTURING; ++i)                                                \
      if (s && g.capturing[i] == s) {                                                      \
        g.capturing[i] = NULL;                                                             \
        found = 1;                                                                         \
      }                                                                                    \
    pthread_mutex_unlock(&g.mu);                                                           \
    if (graph) *graph = (cu_graph_t)0x6a;                                                  \
    return found ? CU__SUCCESS : CU__ERROR_INVALID_VALUE;                                  \
  }

DEFINE_CAPTURE()
DEFINE_CAPTURE(_ptsz)

/* -- cuGetProcAddress ---------------------------------------------------- */

typedef struct {
  const char* name;
  int since;                 /* this ABI from cudaVersion on */
  void* legacy;
  void* ptsz;
} proc_t;

FAKE_API cu_result_t cuGetProcAddress(const char*, void**, int, cu_uint64_t);
FAKE_API cu_result_t cuGetProcAddress_v2(const char*, void**, int, cu_uint64_t,
                                         cu_proc_query_result_t*);

#define PROC(name, since) {#name, since, (void*)name, (void*)name##_ptsz}
#define PROC1(name, fn, since) {name, since, (void*)fn, NULL}

/* newest ABI first: the first row at or under the asked version answers */
static const proc_t g_procs[] = {
    PROC(cuLaunchKernel, 4000),
    PROC(cuLaunchKernelEx, 11060),
    PROC(cuLaunchCooperativeKernel, 9000),
    PROC(cuGraphLaunch, 10000),
    PROC1("cuMemAlloc", cuMemAlloc_v2, 3020),
    PROC(cuMemAllocAsync, 11020),
    PROC(cuMemAllocFromPoolAsync, 11020),
    PROC1("cuMemCreate", cuMemCreate, 10020),
    PROC1("cuMemFree", cuMemFree_v2, 3020),
    PROC(cuMemFreeAsync, 11020),
    PROC1("cuMemRelease", cuMemRelease, 10020),
    {"cuStreamBeginCapture", 10010, (void*)cuStreamBeginCapture_v2,
     (void*)cuStreamBeginCapture_v2_ptsz},
    PROC(cuStreamEndCapture, 10000),
    PROC1("cuEventCreate", cuEventCreate, 2000),
    PROC1("cuEventRecord", cuEventRecord, 2000),
    PROC1("cuEventQuery", cuEventQuery, 2000),
    PROC1("cuEventElapsedTime", cuEventElapsedTime, 2000),
    PROC1("cuEventDestroy", cuEventDestroy_v2, 4000),
    PROC1("cuStreamIsCapturing", cuStreamIsCapturing, 10000),
    PROC1("cuStreamQuery", cuStreamQuery, 2000),
    PROC(cuStreamSynchronize, 2000),
    PROC1("cuCtxSynchronize", cuCtxSynchronize, 2000),
    PROC1("cuStreamDestroy", cuStreamDestroy_v2, 4000),
    PROC1("cuGetProcAddress", cuGetProcAddress_v2, 12000),
    PROC1("cuGetProcAddress", cuGetProcAddress, 11030),
};

static cu_result_t get_proc_address(const char* symbol, void** pfn, int version,
                                    cu_uint64_t flags, cu_proc_query_result_t* status) {
  if (!symbol || !pfn) return CU__ERROR_INVALID_VALUE;
  *pfn = NULL;
  int known = 0;
  for (size_t i = 0; i < sizeof(g_procs) / sizeof(g_procs[0]); ++i) {
    const proc_t* p = &g_procs[i];
    if (strcmp(symbol, p->name) != 0) continue;
    known = 1;
    if (version < p->since) continue;
    int per_thread = (flags & CU__GET_PROC_ADDRESS_PER_THREAD_DEFAULT_STREAM) && p->ptsz;
    *pfn = per_thread ? p->ptsz : p->legacy;
    if (status) *status = CU__GET_PROC_ADDRESS_SUCCESS;
    return CU__SUCCESS;
  }
  if (status)
    *status = known ? CU__GET_PROC_ADDRESS_VERSION_NOT_SUFFICIENT
                    : CU__GET_PROC_ADDRESS_SYMBOL_NOT_FOUND;
  return CU__ERROR_NOT_FOUND;
}

FAKE_API cu_result_t cuGetProcAddress_v2(const char* symbol, void** pfn, int version,
                                         cu_uint64_t flags, cu_proc_query_result_t* status) {
  return get_proc_address(symbol, pfn, version, flags, status);
}

FAKE_API cu_result_t cuGetProcAddress(const char* symbol, void** pfn, int version,
                                      cu_uint64_t flags) {
  return get_proc_address(symbol, pfn, version, flags, NULL);
}

/* -- counts -------------------------------------------------------------- */

/* How many calls of a kind reached the fake: launch, graph_launch,
 * captured_launch, alloc, free, create, release, event_record,
 * capture_event_record, sync, stream_destroy;
 * and the device clock in microseconds (clock_us). */
FAKE_API uint64_t tpf_fake_cuda_count(const char* what) {
  static const struct {
    const char* name;
    uint64_t* value;
  } counts[] = {
      {"launch", &g.launches}, {"graph_launch", &g.graph_launches},
      {"captured_launch", &g.captured_launches}, {"alloc", &g.allocs},
      {"free", &g.frees}, {"create", &g.creates}, {"release", &g.releases},
      {"event_record", &g.event_records}, {"capture_event_record", &g.capture_event_records},
      {"clock_us", &g.clock_us}, {"sync", &g.syncs},
      {"stream_destroy", &g.stream_destroys},
  };
  for (size_t i = 0; i < sizeof(counts) / sizeof(counts[0]); ++i)
    if (strcmp(what, counts[i].name) == 0) return __atomic_load_n(counts[i].value, __ATOMIC_RELAXED);
  return UINT64_MAX;
}
