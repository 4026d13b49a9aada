/*
 * libtpf_cuda_hook.so: mandatory metering of an unmodified CUDA process,
 * the NVIDIA counterpart of native/pjrt_proxy/pjrt_proxy.cc.
 *
 * The node agent puts this library into LD_PRELOAD of every worker it
 * spawns.  It interposes the CUDA driver entries that torch, cudart (shared
 * or static) and the port's own kernel libraries reach, and charges them
 * against the worker's shm segment through libtpf_limiter.so:
 *
 *   launches  cuLaunchKernel, cuLaunchKernelEx, cuLaunchCooperativeKernel,
 *             cuGraphLaunch (and their _ptsz variants): charged in measured
 *             device time, converted to MFLOP at TPF_PEAK_MFLOPS (the
 *             card's peak, the unit the node agent refills buckets in), so
 *             one device-second costs the peak's MFLOPs.  Each launch pays,
 *             before it runs, for the device time of the windows that have
 *             completed since the last payment, and sleeps the limiter's
 *             wait hints while the bucket refuses: the charge is taken in
 *             arrears.  A frozen worker blocks at its next launch.
 *   memory    cuMemAlloc_v2, cuMemAllocAsync, cuMemAllocFromPoolAsync and
 *             cuMemCreate charge device memory; cuMemFree_v2, cuMemFreeAsync
 *             and cuMemRelease release it.  As in the reference, an
 *             allocation over the budget is accounted (hbm_denied), not
 *             failed: hard limits belong to the provider.
 *   capture   cuStreamBeginCapture(ToGraph) / cuStreamEndCapture are
 *             tracked with their mode.  A launch on a capturing stream,
 *             which is recorded and not run, is not charged, and no event
 *             is recorded or stream queried on such a stream.  While a
 *             global-mode capture is underway anywhere in the process (an
 *             event query in any thread would invalidate it), or a
 *             thread-local one in the launching thread, the hook records
 *             and queries nothing and charges no launch; launches on other
 *             streams during a relaxed or another thread's thread-local
 *             capture are charged as usual.
 *   streams   cuStreamDestroy drops a stream's entry once its windows are
 *             read, so a process that cycles through streams keeps timing
 *             them.
 *
 * Device time is measured with timing events on the launching stream.  A
 * *window* is a start event recorded before its first launch and an end
 * event recorded after some of its launches: the first, every END_EVERY-th, one
 * made into an idle stream (the host is behind, nothing queues), and the
 * last one before a cuStreamSynchronize or cuCtxSynchronize that waits for
 * it; a busy stream is otherwise given no event between its kernels, each
 * of which would cost the card a few microseconds.  A window closes when
 * its stream has drained (cuStreamQuery, on the host, at the next launch:
 * it then ends at its last end, and any launches after that go untimed
 * rather than an idle gap being charged), after WINDOW_LAUNCHES launches,
 * or after WINDOW_US of host time.  A graph launch is a window of its own.  Closed windows
 * are read without blocking (cuEventQuery, then cuEventElapsedTime) before
 * each launch.  An event window spans whatever else the card ran
 * meanwhile, so a tenant that shares the card by time slicing pays for the
 * slices it waited through.
 *
 * Resolution.  CUDA 12's runtime dlopens libcuda.so.1, dlsyms
 * cuGetProcAddress(_v2) on that handle and takes every driver entry from
 * it, so a preloaded cuLaunchKernel alone sees nothing.  The hook therefore
 * interposes dlsym (the real one comes from dlvsym), hands back its own
 * cuGetProcAddress(_v2), and that returns a wrapper for each entry above,
 * for the ABI version and stream variant the caller asked for.  The
 * entries are exported under their own names too, for callers that link
 * libcuda directly.  The hook's own event calls go to the driver directly.
 *
 * The limiter is reached through dlopen(TPF_LIMITER_LIB) at the first
 * launch or allocation (or tpf_cuda_hook_metered()); with no TPF_SHM_PATH
 * every call passes through unmetered.  Build (no CUDA toolkit needed):
 *
 *   cc -std=c11 -O2 -Wall -shared -fPIC cuda_hook.c -o libtpf_cuda_hook.so -ldl -lpthread
 *
 * Environment: TPF_SHM_PATH, TPF_LIMITER_LIB, TPF_DEVICE_INDEX,
 * TPF_PEAK_MFLOPS (default 1e6), TPF_CUDA_HOOK_VERBOSE.
 */

#define _GNU_SOURCE
#include <dlfcn.h>
#include <pthread.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

#include "cuda_types.h"

#define HOOK_API __attribute__((visibility("default")))

/* ------------------------------------------------------------------ */
/* the limiter's worker face (native/include/tpufusion/limiter.h),     */
/* redeclared so the hook builds against no header of the reference    */
/* ------------------------------------------------------------------ */

typedef int32_t tpf_status_t;
typedef struct {
  uint8_t allowed;
  uint8_t frozen;
  uint64_t available;
  uint64_t wait_hint_us;
} tfl_charge_result_t;
typedef tpf_status_t (*tfl_attach_fn)(const char*);
typedef tpf_status_t (*tfl_charge_compute_fn)(uint32_t, uint64_t, tfl_charge_result_t*);
typedef tpf_status_t (*tfl_charge_hbm_fn)(uint32_t, int64_t, tfl_charge_result_t*);
typedef tpf_status_t (*tfl_self_register_pid_fn)(void);
typedef uint8_t (*tfl_worker_frozen_fn)(void);

/* ------------------------------------------------------------------ */
/* driver entry types                                                  */
/* ------------------------------------------------------------------ */

typedef cu_result_t (*launch_kernel_fn)(cu_function_t, unsigned, unsigned, unsigned,
                                        unsigned, unsigned, unsigned, unsigned,
                                        cu_stream_t, void**, void**);
typedef cu_result_t (*launch_kernel_ex_fn)(const cu_launch_config_t*, cu_function_t,
                                           void**, void**);
typedef cu_result_t (*launch_coop_fn)(cu_function_t, unsigned, unsigned, unsigned,
                                      unsigned, unsigned, unsigned, unsigned,
                                      cu_stream_t, void**);
typedef cu_result_t (*graph_launch_fn)(cu_graph_exec_t, cu_stream_t);
typedef cu_result_t (*mem_alloc_fn)(cu_deviceptr_t*, size_t);
typedef cu_result_t (*mem_alloc_async_fn)(cu_deviceptr_t*, size_t, cu_stream_t);
typedef cu_result_t (*mem_alloc_pool_async_fn)(cu_deviceptr_t*, size_t, cu_mem_pool_t,
                                               cu_stream_t);
typedef cu_result_t (*mem_create_fn)(cu_mem_handle_t*, size_t,
                                     const cu_mem_allocation_prop_t*, unsigned long long);
typedef cu_result_t (*mem_free_fn)(cu_deviceptr_t);
typedef cu_result_t (*mem_free_async_fn)(cu_deviceptr_t, cu_stream_t);
typedef cu_result_t (*mem_release_fn)(cu_mem_handle_t);
typedef cu_result_t (*begin_capture_fn)(cu_stream_t, cu_capture_mode_t);
typedef cu_result_t (*begin_capture_to_graph_fn)(cu_stream_t, cu_graph_t, const void*,
                                                 const void*, size_t, cu_capture_mode_t);
typedef cu_result_t (*end_capture_fn)(cu_stream_t, cu_graph_t*);
typedef cu_result_t (*gpa_fn)(const char*, void**, int, cu_uint64_t);
typedef cu_result_t (*gpa_v2_fn)(const char*, void**, int, cu_uint64_t,
                                 cu_proc_query_result_t*);
typedef cu_result_t (*event_create_fn)(cu_event_t*, unsigned int);
typedef cu_result_t (*event_record_fn)(cu_event_t, cu_stream_t);
typedef cu_result_t (*event_query_fn)(cu_event_t);
typedef cu_result_t (*event_elapsed_fn)(float*, cu_event_t, cu_event_t);
typedef cu_result_t (*event_destroy_fn)(cu_event_t);
typedef cu_result_t (*stream_is_capturing_fn)(cu_stream_t, cu_capture_status_t*);
typedef cu_result_t (*stream_query_fn)(cu_stream_t);
typedef cu_result_t (*stream_sync_fn)(cu_stream_t);
typedef cu_result_t (*stream_destroy_fn)(cu_stream_t);
typedef cu_result_t (*ctx_sync_fn)(void);
typedef void* (*dlsym_fn)(void*, const char*);

/* ------------------------------------------------------------------ */
/* the interposed entries                                              */
/* ------------------------------------------------------------------ */

enum {
  E_LAUNCH_KERNEL,
  E_LAUNCH_KERNEL_EX,
  E_LAUNCH_COOPERATIVE,
  E_GRAPH_LAUNCH,
  E_MEM_ALLOC,
  E_MEM_ALLOC_ASYNC,
  E_MEM_ALLOC_POOL_ASYNC,
  E_MEM_CREATE,
  E_MEM_FREE,
  E_MEM_FREE_ASYNC,
  E_MEM_RELEASE,
  E_BEGIN_CAPTURE,
  E_BEGIN_CAPTURE_TO_GRAPH,
  E_END_CAPTURE,
  E_STREAM_SYNC,
  E_STREAM_DESTROY,
  E_CTX_SYNC,
  E_GET_PROC_ADDRESS,      /* variant 0: the 4-argument v1, 1: _v2 */
  N_ENTRIES
};

typedef struct {
  const char* base;          /* the name cuGetProcAddress is asked for */
  const char* exported[2];   /* symbol names: legacy stream, per-thread stream */
  int min_version;           /* the first cudaVersion of the ABI wrapped */
  void* wrapper[2];
  void* real[2];             /* the driver's, set at first resolution */
  uint64_t calls[2];
} entry_t;

/* The wrappers are the hook's exported functions of the same names, so
 * that a lookup which finds the hook's own export is known for one. */
#define LAUNCH_KERNEL_PARAMS                                                     \
  cu_function_t f, unsigned gx, unsigned gy, unsigned gz, unsigned bx,           \
      unsigned by, unsigned bz, unsigned smem, cu_stream_t s, void **params,     \
      void **extra
#define LAUNCH_KERNEL_EX_PARAMS \
  const cu_launch_config_t *c, cu_function_t f, void **params, void **extra
#define LAUNCH_COOP_PARAMS                                                       \
  cu_function_t f, unsigned gx, unsigned gy, unsigned gz, unsigned bx,           \
      unsigned by, unsigned bz, unsigned smem, cu_stream_t s, void **params
#define GRAPH_LAUNCH_PARAMS cu_graph_exec_t exec, cu_stream_t s
#define MEM_ALLOC_ASYNC_PARAMS cu_deviceptr_t *dptr, size_t size, cu_stream_t s
#define MEM_ALLOC_POOL_ASYNC_PARAMS \
  cu_deviceptr_t *dptr, size_t size, cu_mem_pool_t pool, cu_stream_t s
#define MEM_FREE_ASYNC_PARAMS cu_deviceptr_t dptr, cu_stream_t s
#define BEGIN_CAPTURE_PARAMS cu_stream_t s, cu_capture_mode_t mode
#define BEGIN_CAPTURE_TO_GRAPH_PARAMS                                            \
  cu_stream_t s, cu_graph_t graph, const void *deps, const void *edges,          \
      size_t n, cu_capture_mode_t mode
#define END_CAPTURE_PARAMS cu_stream_t s, cu_graph_t *graph
#define STREAM_SYNC_PARAMS cu_stream_t s

#define BOTH(ret, name, params)             \
  HOOK_API ret name(params);                \
  HOOK_API ret name##_ptsz(params);
BOTH(cu_result_t, cuLaunchKernel, LAUNCH_KERNEL_PARAMS)
BOTH(cu_result_t, cuLaunchKernelEx, LAUNCH_KERNEL_EX_PARAMS)
BOTH(cu_result_t, cuLaunchCooperativeKernel, LAUNCH_COOP_PARAMS)
BOTH(cu_result_t, cuGraphLaunch, GRAPH_LAUNCH_PARAMS)
BOTH(cu_result_t, cuMemAllocAsync, MEM_ALLOC_ASYNC_PARAMS)
BOTH(cu_result_t, cuMemAllocFromPoolAsync, MEM_ALLOC_POOL_ASYNC_PARAMS)
BOTH(cu_result_t, cuMemFreeAsync, MEM_FREE_ASYNC_PARAMS)
BOTH(cu_result_t, cuStreamBeginCapture_v2, BEGIN_CAPTURE_PARAMS)
BOTH(cu_result_t, cuStreamBeginCaptureToGraph, BEGIN_CAPTURE_TO_GRAPH_PARAMS)
BOTH(cu_result_t, cuStreamEndCapture, END_CAPTURE_PARAMS)
BOTH(cu_result_t, cuStreamSynchronize, STREAM_SYNC_PARAMS)
#undef BOTH
HOOK_API cu_result_t cuMemAlloc_v2(cu_deviceptr_t*, size_t);
HOOK_API cu_result_t cuMemCreate(cu_mem_handle_t*, size_t, const cu_mem_allocation_prop_t*,
                                 unsigned long long);
HOOK_API cu_result_t cuMemFree_v2(cu_deviceptr_t);
HOOK_API cu_result_t cuMemRelease(cu_mem_handle_t);
HOOK_API cu_result_t cuStreamDestroy_v2(cu_stream_t);
HOOK_API cu_result_t cuCtxSynchronize(void);
HOOK_API cu_result_t cuGetProcAddress(const char*, void**, int, cu_uint64_t);
HOOK_API cu_result_t cuGetProcAddress_v2(const char*, void**, int, cu_uint64_t,
                                         cu_proc_query_result_t*);

#define ENTRY(base, name, version) \
  {base, {#name, #name "_ptsz"}, version, {(void*)name, (void*)name##_ptsz}}
#define ENTRY1(base, name, version) {base, {#name, NULL}, version, {(void*)name, NULL}}

static entry_t g_entries[N_ENTRIES] = {
    [E_LAUNCH_KERNEL] = ENTRY("cuLaunchKernel", cuLaunchKernel, 4000),
    [E_LAUNCH_KERNEL_EX] = ENTRY("cuLaunchKernelEx", cuLaunchKernelEx, 11060),
    [E_LAUNCH_COOPERATIVE] =
        ENTRY("cuLaunchCooperativeKernel", cuLaunchCooperativeKernel, 9000),
    [E_GRAPH_LAUNCH] = ENTRY("cuGraphLaunch", cuGraphLaunch, 10000),
    [E_MEM_ALLOC] = ENTRY1("cuMemAlloc", cuMemAlloc_v2, 3020),
    [E_MEM_ALLOC_ASYNC] = ENTRY("cuMemAllocAsync", cuMemAllocAsync, 11020),
    [E_MEM_ALLOC_POOL_ASYNC] =
        ENTRY("cuMemAllocFromPoolAsync", cuMemAllocFromPoolAsync, 11020),
    [E_MEM_CREATE] = ENTRY1("cuMemCreate", cuMemCreate, 10020),
    [E_MEM_FREE] = ENTRY1("cuMemFree", cuMemFree_v2, 3020),
    [E_MEM_FREE_ASYNC] = ENTRY("cuMemFreeAsync", cuMemFreeAsync, 11020),
    [E_MEM_RELEASE] = ENTRY1("cuMemRelease", cuMemRelease, 10020),
    [E_BEGIN_CAPTURE] = ENTRY("cuStreamBeginCapture", cuStreamBeginCapture_v2, 10010),
    [E_BEGIN_CAPTURE_TO_GRAPH] =
        ENTRY("cuStreamBeginCaptureToGraph", cuStreamBeginCaptureToGraph, 12030),
    [E_END_CAPTURE] = ENTRY("cuStreamEndCapture", cuStreamEndCapture, 10000),
    [E_STREAM_SYNC] = ENTRY("cuStreamSynchronize", cuStreamSynchronize, 2000),
    [E_STREAM_DESTROY] = ENTRY1("cuStreamDestroy", cuStreamDestroy_v2, 4000),
    /* wrapped only where the table's answer is the exported (first) ABI */
    [E_CTX_SYNC] = ENTRY1("cuCtxSynchronize", cuCtxSynchronize, 2000),
    /* variant 0 is the 4-argument v1, variant 1 the _v2 of CUDA 12 */
    [E_GET_PROC_ADDRESS] = {"cuGetProcAddress",
                            {"cuGetProcAddress", "cuGetProcAddress_v2"},
                            11030,
                            {(void*)cuGetProcAddress, (void*)cuGetProcAddress_v2}},
};
#undef ENTRY
#undef ENTRY1

/* ------------------------------------------------------------------ */
/* state                                                               */
/* ------------------------------------------------------------------ */

typedef struct window {
  cu_event_t start, end;
  struct window* next;
} window_t;

typedef struct {
  uintptr_t key;             /* the stream, or the thread for a per-thread stream;
                                0: a destroyed stream's entry, free once read */
  cu_stream_t stream;        /* the handle events are recorded on */
  int per_thread;            /* the per-thread default stream of `owner` */
  pthread_t owner;
  window_t* open;            /* start recorded; end as the rule in the header says */
  unsigned launches;         /* launches in the open window */
  unsigned since_end;        /* of which after its end was last recorded */
  unsigned inflight;         /* launches between their begin and their end */
  uint64_t opened_ns;        /* host time the open window opened */
  uint64_t last_launch_ns;
  window_t* head;            /* closed windows, oldest first */
  window_t* tail;
} stream_state_t;

#define MAX_STREAMS 256
#define MAX_CAPTURES 64
#define END_EVERY 16               /* a busy window's end, every so many launches */
#define WINDOW_LAUNCHES 64         /* a busy window closes after so many launches */
#define WINDOW_US 2000             /* ... or so long after it opened (host time) */
/* the longest single sleep on a wait hint: a refill the node agent raises
 * (each 100 ms tick) is seen within a fifth of a tick */
#define MAX_SLEEP_US 20000

typedef struct {
  cu_stream_t stream;
  cu_capture_mode_t mode;
  pthread_t thread;          /* the thread that began it */
} capture_t;

typedef struct {
  uint64_t key;
  uint64_t size;
  uint8_t state;             /* 0 empty, 1 live, 2 deleted */
  uint8_t kind;              /* 0 device pointer, 1 allocation handle */
  uint8_t admitted;          /* charged to the segment (not denied) */
} mem_slot_t;

static struct {
  dlsym_fn real_dlsym;
  void* libcuda;
  event_create_fn ev_create;
  event_record_fn ev_record;
  event_query_fn ev_query;
  event_elapsed_fn ev_elapsed;
  event_destroy_fn ev_destroy;
  stream_is_capturing_fn is_capturing;
  stream_query_fn stream_query;

  pthread_once_t attach_once;
  int metered;
  void* limiter;
  tfl_charge_compute_fn charge_compute;
  tfl_charge_hbm_fn charge_hbm;
  tfl_worker_frozen_fn worker_frozen;
  uint32_t device_index;
  double peak_mflops;        /* MFLOP charged for one device-second */
  int verbose;

  pthread_mutex_t mu;        /* streams, windows, memory map, gathered totals */
  stream_state_t streams[MAX_STREAMS];
  unsigned n_streams;
  window_t* free_windows;
  uint64_t device_ns;        /* device time of the windows read */
  uint64_t gathered_mflop;   /* device_ns at the peak */
  uint64_t taken_mflop;      /* of which launches have taken to pay */
  mem_slot_t* mem;
  size_t mem_cap, mem_used;

  /* captures begun here and not seen to end */
  capture_t capturing[MAX_CAPTURES];
  int n_capturing;

  /* stats (tpf_cuda_hook_stats / tpf_cuda_hook_report) */
  uint64_t launches;         /* launches metered (kernels and graphs) */
  uint64_t graph_launches;
  uint64_t charges;          /* admitted compute charges: the segment's launches */
  uint64_t charged_mflops;
  uint64_t blocked_us;
  int64_t hbm_charged_bytes;
  uint64_t hbm_denied;
  uint64_t captured;         /* launches not charged: captured, or while a capture
                                forbids the hook's own calls */
  uint64_t windows;
  uint64_t window_errors;
  uint64_t unwindowed;       /* launches with no window (stream table full) */
  uint64_t streams_dropped;  /* entries of destroyed streams */
  uint64_t untimed;          /* launches after a window's last end, its stream drained */
  uint64_t limiter_errors;
  uint64_t wrapped_by_gpa;   /* entries handed out through cuGetProcAddress */
  uint64_t wrapped_by_dlsym; /* ... through dlsym */
} g = {
    .attach_once = PTHREAD_ONCE_INIT,
    .mu = PTHREAD_MUTEX_INITIALIZER,
    .peak_mflops = 1e6,
};

static void logmsg(const char* msg) {
  if (g.verbose) fprintf(stderr, "[tpf_cuda_hook] %s\n", msg);
}

static uint64_t now_ns(void) {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (uint64_t)ts.tv_sec * 1000000000ull + (uint64_t)ts.tv_nsec;
}

static void bump(uint64_t* counter, uint64_t by) {
  __atomic_add_fetch(counter, by, __ATOMIC_RELAXED);
}

/* ------------------------------------------------------------------ */
/* resolution                                                          */
/* ------------------------------------------------------------------ */

static void init_real_dlsym(void) {
  if (g.real_dlsym) return;
  dlsym_fn f = (dlsym_fn)dlvsym(RTLD_NEXT, "dlsym", "GLIBC_2.34");
  if (!f) f = (dlsym_fn)dlvsym(RTLD_NEXT, "dlsym", "GLIBC_2.2.5");
  __atomic_store_n(&g.real_dlsym, f, __ATOMIC_RELEASE);
}

__attribute__((constructor)) static void hook_init(void) {
  init_real_dlsym();
  g.verbose = getenv("TPF_CUDA_HOOK_VERBOSE") != NULL;
}

static void* libcuda(void) {
  void* h = __atomic_load_n(&g.libcuda, __ATOMIC_ACQUIRE);
  if (!h) {
    h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    if (h) __atomic_store_n(&g.libcuda, h, __ATOMIC_RELEASE);
  }
  return h;
}

static int is_wrapper(void* p) {
  for (int e = 0; e < N_ENTRIES; ++e)
    if (p && (p == g_entries[e].wrapper[0] || p == g_entries[e].wrapper[1])) return 1;
  return 0;
}

/* The driver's function behind entry e, variant v: the first pointer the
 * caller's own resolution returned, else the exported symbol of libcuda. */
static void* real_of(int e, int v) {
  void* p = __atomic_load_n(&g_entries[e].real[v], __ATOMIC_ACQUIRE);
  if (p) return p;
  void* h = libcuda();
  if (h && g_entries[e].exported[v]) p = g.real_dlsym(h, g_entries[e].exported[v]);
  if (p && !is_wrapper(p)) {
    void* none = NULL;
    __atomic_compare_exchange_n(&g_entries[e].real[v], &none, p, 0, __ATOMIC_ACQ_REL,
                                __ATOMIC_ACQUIRE);
    return __atomic_load_n(&g_entries[e].real[v], __ATOMIC_ACQUIRE);
  }
  return NULL;
}

/* Remember `real` as entry e's variant v (the first one wins: every
 * pointer handed out for one entry and variant at a version at or past
 * min_version has the same ABI) and return the wrapper. */
static void* wrap(int e, int v, void* real) {
  void* none = NULL;
  if (is_wrapper(real)) return real;
  __atomic_compare_exchange_n(&g_entries[e].real[v], &none, real, 0, __ATOMIC_ACQ_REL,
                              __ATOMIC_ACQUIRE);
  return g_entries[e].wrapper[v];
}

/* Which stream variant a cuGetProcAddress answer is: the flag says so, and
 * the default search is compared with the per-thread one. */
static int variant_of(int e, const char* symbol, void* got, int version, cu_uint64_t flags) {
  if (!g_entries[e].wrapper[1]) return 0;
  if (flags & CU__GET_PROC_ADDRESS_PER_THREAD_DEFAULT_STREAM) return 1;
  if (flags & CU__GET_PROC_ADDRESS_LEGACY_STREAM) return 0;
  gpa_v2_fn real2 = (gpa_v2_fn)real_of(E_GET_PROC_ADDRESS, 1);
  void* ptds = NULL;
  cu_proc_query_result_t st = 0;
  if (real2 && real2(symbol, &ptds, version,
                     CU__GET_PROC_ADDRESS_PER_THREAD_DEFAULT_STREAM, &st) == CU__SUCCESS &&
      ptds == got)
    return 1;
  return 0;
}

static void wrap_proc(const char* symbol, void** pfn, int version, cu_uint64_t flags) {
  if (!symbol || !pfn || !*pfn) return;
  for (int e = 0; e < N_ENTRIES; ++e) {
    if (strcmp(symbol, g_entries[e].base) != 0) continue;
    if (version < g_entries[e].min_version) return;   /* an older ABI: not wrapped */
    int v;
    if (e == E_GET_PROC_ADDRESS) {
      v = version >= 12000;
    } else if (e == E_CTX_SYNC) {
      void* h = libcuda();
      if (!h || *pfn != g.real_dlsym(h, "cuCtxSynchronize")) return;
      v = 0;
    } else {
      v = variant_of(e, symbol, *pfn, version, flags);
    }
    *pfn = wrap(e, v, *pfn);
    bump(&g.wrapped_by_gpa, 1);
    return;
  }
}

HOOK_API cu_result_t cuGetProcAddress_v2(const char* symbol, void** pfn, int version,
                                         cu_uint64_t flags, cu_proc_query_result_t* status) {
  bump(&g_entries[E_GET_PROC_ADDRESS].calls[1], 1);
  gpa_v2_fn real = (gpa_v2_fn)real_of(E_GET_PROC_ADDRESS, 1);
  if (!real) return CU__ERROR_NOT_FOUND;
  cu_result_t r = real(symbol, pfn, version, flags, status);
  if (r == CU__SUCCESS && (!status || *status == CU__GET_PROC_ADDRESS_SUCCESS))
    wrap_proc(symbol, pfn, version, flags);
  return r;
}

HOOK_API cu_result_t cuGetProcAddress(const char* symbol, void** pfn, int version,
                                      cu_uint64_t flags) {
  bump(&g_entries[E_GET_PROC_ADDRESS].calls[0], 1);
  gpa_fn real = (gpa_fn)real_of(E_GET_PROC_ADDRESS, 0);
  if (!real) return CU__ERROR_NOT_FOUND;
  cu_result_t r = real(symbol, pfn, version, flags);
  if (r == CU__SUCCESS) wrap_proc(symbol, pfn, version, flags);
  return r;
}

/* dlsym(handle, name): the driver's entries and cuGetProcAddress come back
 * wrapped; every other name goes to the real dlsym as a tail call, so
 * that RTLD_NEXT still resolves relative to the caller. */
HOOK_API void* dlsym(void* handle, const char* name) {
  if (__builtin_expect(g.real_dlsym == NULL, 0)) init_real_dlsym();
  if (name[0] == 'c' && name[1] == 'u') {
    for (int e = 0; e < N_ENTRIES; ++e) {
      for (int v = 0; v < 2; ++v) {
        const char* exported = g_entries[e].exported[v];
        if (!exported || strcmp(name, exported) != 0) continue;
        void* real = g.real_dlsym(handle, name);
        if (!real) return NULL;
        bump(&g.wrapped_by_dlsym, 1);
        return wrap(e, v, real);
      }
    }
  }
  return g.real_dlsym(handle, name);
}

static void resolve_event_api(void) {
  void* h = libcuda();
  if (!h) return;
  g.ev_create = (event_create_fn)g.real_dlsym(h, "cuEventCreate");
  g.ev_record = (event_record_fn)g.real_dlsym(h, "cuEventRecord");
  g.ev_query = (event_query_fn)g.real_dlsym(h, "cuEventQuery");
  g.ev_elapsed = (event_elapsed_fn)g.real_dlsym(h, "cuEventElapsedTime");
  g.ev_destroy = (event_destroy_fn)g.real_dlsym(h, "cuEventDestroy_v2");
  g.is_capturing = (stream_is_capturing_fn)g.real_dlsym(h, "cuStreamIsCapturing");
  g.stream_query = (stream_query_fn)g.real_dlsym(h, "cuStreamQuery");
}

/* ------------------------------------------------------------------ */
/* attach (pjrt_proxy.cc attach_limiter)                               */
/* ------------------------------------------------------------------ */

static double env_double(const char* name, double fallback) {
  const char* s = getenv(name);
  if (!s || !*s) return fallback;
  char* end = NULL;
  double v = strtod(s, &end);
  return (end && end != s && v > 0) ? v : fallback;
}

static void attach_limiter(void) {
  g.peak_mflops = env_double("TPF_PEAK_MFLOPS", g.peak_mflops);
  const char* idx = getenv("TPF_DEVICE_INDEX");
  if (idx && *idx) g.device_index = (uint32_t)atoi(idx);

  const char* shm_path = getenv("TPF_SHM_PATH");
  if (!shm_path || !*shm_path) {
    logmsg("no TPF_SHM_PATH: pass-through (unmetered)");
    return;
  }
  const char* lib = getenv("TPF_LIMITER_LIB");
  if (!lib || !*lib) lib = "libtpf_limiter.so";
  g.limiter = dlopen(lib, RTLD_NOW | RTLD_LOCAL);
  if (!g.limiter) {
    fprintf(stderr, "[tpf_cuda_hook] cannot dlopen limiter %s: %s (running unmetered)\n", lib,
            dlerror());
    return;
  }
  tfl_attach_fn attach = (tfl_attach_fn)g.real_dlsym(g.limiter, "tfl_attach");
  tfl_self_register_pid_fn self_pid =
      (tfl_self_register_pid_fn)g.real_dlsym(g.limiter, "tfl_self_register_pid");
  g.charge_compute = (tfl_charge_compute_fn)g.real_dlsym(g.limiter, "tfl_charge_compute");
  g.charge_hbm = (tfl_charge_hbm_fn)g.real_dlsym(g.limiter, "tfl_charge_hbm");
  g.worker_frozen = (tfl_worker_frozen_fn)g.real_dlsym(g.limiter, "tfl_worker_frozen");
  if (!attach || !g.charge_compute || !g.charge_hbm) {
    fprintf(stderr, "[tpf_cuda_hook] limiter ABI incomplete; unmetered\n");
    return;
  }
  if (attach(shm_path) != 0) {
    fprintf(stderr, "[tpf_cuda_hook] tfl_attach(%s) failed; unmetered\n", shm_path);
    return;
  }
  if (self_pid) self_pid();
  resolve_event_api();
  if (!g.ev_create || !g.ev_record || !g.ev_query || !g.ev_elapsed || !g.ev_destroy ||
      !g.is_capturing || !g.stream_query) {
    fprintf(stderr, "[tpf_cuda_hook] libcuda.so.1 lacks the event calls; unmetered\n");
    return;
  }
  g.metered = 1;
  logmsg("metering active");
}

static int metered(void) {
  pthread_once(&g.attach_once, attach_limiter);
  return g.metered;
}

/* ------------------------------------------------------------------ */
/* compute: windows, gathering, payment (pjrt_proxy.cc proxy_execute)  */
/* ------------------------------------------------------------------ */

/* Whether a capture forbids the calling thread the hook's own event and
 * stream calls: a global-mode capture underway anywhere in the process, or
 * a thread-local one begun in this thread (a relaxed one forbids nothing).
 * Each capture is asked again first (cuStreamIsCapturing is allowed during
 * a capture), so one whose end went by another entry is dropped. */
static int capture_forbids_calls(void) {
  if (__atomic_load_n(&g.n_capturing, __ATOMIC_ACQUIRE) == 0) return 0;
  pthread_t self = pthread_self();
  int forbids = 0;
  pthread_mutex_lock(&g.mu);
  for (int i = 0; i < g.n_capturing;) {
    capture_t* c = &g.capturing[i];
    cu_capture_status_t cs = CU__STREAM_CAPTURE_STATUS_NONE;
    int pseudo = c->stream == CU__STREAM_LEGACY || c->stream == CU__STREAM_PER_THREAD;
    if (!pseudo && g.is_capturing(c->stream, &cs) == CU__SUCCESS &&
        cs == CU__STREAM_CAPTURE_STATUS_NONE) {
      *c = g.capturing[--g.n_capturing];
      continue;
    }
    if (c->mode == CU__STREAM_CAPTURE_MODE_GLOBAL ||
        (c->mode == CU__STREAM_CAPTURE_MODE_THREAD_LOCAL && pthread_equal(c->thread, self)))
      forbids = 1;
    ++i;
  }
  pthread_mutex_unlock(&g.mu);
  return forbids;
}

/* Whether a stream is being captured: a launch on it is recorded, not run,
 * and an event recorded on it would join the graph.  Asked only while a
 * capture is underway (a stream can join one through an event wait). */
static int stream_capturing(cu_stream_t s) {
  if (__atomic_load_n(&g.n_capturing, __ATOMIC_ACQUIRE) == 0) return 0;
  cu_capture_status_t cs = CU__STREAM_CAPTURE_STATUS_NONE;
  return g.is_capturing(s, &cs) != CU__SUCCESS || cs != CU__STREAM_CAPTURE_STATUS_NONE;
}

/* The stream a launch names, as the hook records on it, and its table key:
 * stream 0 is the legacy default stream in a legacy entry and the calling
 * thread's own default stream in a per-thread one. */
static cu_stream_t normal_stream(cu_stream_t s, int v, uintptr_t* key) {
  if (s == NULL) s = v ? CU__STREAM_PER_THREAD : CU__STREAM_LEGACY;
  *key = s == CU__STREAM_PER_THREAD ? ((uintptr_t)pthread_self() | 3u) : (uintptr_t)s;
  return s;
}

static stream_state_t* stream_locked(uintptr_t key, cu_stream_t s) {
  stream_state_t* st = NULL;
  for (unsigned i = 0; i < g.n_streams; ++i) {
    if (g.streams[i].key == key) return &g.streams[i];
    if (!st && g.streams[i].key == 0 && !g.streams[i].head) st = &g.streams[i];
  }
  if (!st) {
    if (g.n_streams == MAX_STREAMS) return NULL;
    st = &g.streams[g.n_streams++];
  }
  memset(st, 0, sizeof(*st));
  st->key = key;
  st->stream = s;
  st->per_thread = s == CU__STREAM_PER_THREAD;
  st->owner = pthread_self();
  return st;
}


static window_t* new_window_locked(void) {
  window_t* w = g.free_windows;
  if (w) {
    g.free_windows = w->next;
    w->next = NULL;
    return w;
  }
  w = calloc(1, sizeof(*w));
  if (!w) return NULL;
  if (g.ev_create(&w->start, CU__EVENT_DEFAULT) != CU__SUCCESS) {
    free(w);
    return NULL;
  }
  if (g.ev_create(&w->end, CU__EVENT_DEFAULT) != CU__SUCCESS) {
    g.ev_destroy(w->start);
    free(w);
    return NULL;
  }
  return w;
}

static void drop_window_locked(window_t* w, int broken) {
  if (broken) {
    g.ev_destroy(w->start);
    g.ev_destroy(w->end);
    free(w);
    return;
  }
  w->next = g.free_windows;
  g.free_windows = w;
}

static void read_window_locked(window_t* w) {
  float ms = 0.f;
  if (g.ev_elapsed(&ms, w->start, w->end) == CU__SUCCESS) {
    g.device_ns += (uint64_t)((double)ms * 1e6 + 0.5);
    g.windows++;
    drop_window_locked(w, 0);
  } else {
    g.window_errors++;
    drop_window_locked(w, 1);
  }
}

/* Close the stream's open window: read it now if its end has completed,
 * else queue it behind the stream's other closed windows. */
static void close_open_locked(stream_state_t* st, int completed) {
  window_t* w = st->open;
  if (!w) return;
  st->open = NULL;
  if (st->launches == 0) {           /* its one launch failed: nothing to time */
    drop_window_locked(w, 0);
    return;
  }
  if (completed && !st->head) {
    read_window_locked(w);
    return;
  }
  w->next = NULL;
  if (st->tail) st->tail->next = w;
  else st->head = w;
  st->tail = w;
}

/* Events can be recorded on a per-thread stream only from its thread. */
static int recordable(const stream_state_t* st) {
  return !st->per_thread || pthread_equal(st->owner, pthread_self());
}

/* Record the open window's end now (the stream is busy, or about to be
 * waited for: the end then marks its last launch). */
static void mark_end_locked(stream_state_t* st) {
  if (!st->open || st->since_end == 0 || st->inflight || !recordable(st) ||
      stream_capturing(st->stream))
    return;
  if (g.ev_record(st->open->end, st->stream) == CU__SUCCESS) st->since_end = 0;
  else g.window_errors++;
}

/* The stream has drained: its window ends at its last recorded end, and
 * the launches after that go untimed rather than an idle gap charged. */
static void close_drained_locked(stream_state_t* st) {
  g.untimed += st->since_end;
  close_open_locked(st, 1);
}

/* Read every closed window that has completed, and close the open windows
 * whose streams have drained.  Never blocks.  Returns the MFLOPs of device
 * time read since the last call, which the caller pays. */
static uint64_t gather_locked(void) {
  uint64_t now = now_ns();
  for (unsigned i = 0; i < g.n_streams; ++i) {
    stream_state_t* st = &g.streams[i];
    if (st->open && st->inflight == 0 && st->launches > 0) {
      if (st->since_end == 0) {          /* its end marks its last launch */
        cu_result_t r = g.ev_query(st->open->end);
        if (r == CU__SUCCESS) {
          close_open_locked(st, 1);
        } else if (r != CU__ERROR_NOT_READY) {
          drop_window_locked(st->open, 1);
          st->open = NULL;
          g.window_errors++;
        }
      } else if (recordable(st) && now - st->last_launch_ns >= WINDOW_US * 1000ull &&
                 !stream_capturing(st->stream) && g.stream_query(st->stream) == CU__SUCCESS) {
        close_drained_locked(st);        /* a stream gone quiet */
      }
    }
    while (st->head) {
      window_t* w = st->head;
      cu_result_t r = g.ev_query(w->end);
      if (r == CU__ERROR_NOT_READY) break;
      st->head = w->next;
      if (!st->head) st->tail = NULL;
      if (r == CU__SUCCESS) {
        read_window_locked(w);
      } else {
        g.window_errors++;
        drop_window_locked(w, 1);
      }
    }
  }
  g.gathered_mflop = (uint64_t)((double)g.device_ns * g.peak_mflops / 1e9);
  uint64_t due = g.gathered_mflop > g.taken_mflop ? g.gathered_mflop - g.taken_mflop : 0;
  g.taken_mflop += due;
  return due;
}

static void sleep_us(uint64_t us) {
  struct timespec ts = {(time_t)(us / 1000000), (long)((us % 1000000) * 1000)};
  nanosleep(&ts, NULL);
}

/* Charge `mflop` (0 too: a frozen worker is refused even that), sleeping
 * the wait hints while refused.  A debt larger than the bucket can ever
 * hold (refused twice at the same full level) is paid in parts. */
static void pay(uint64_t mflop) {
  uint64_t last_available = UINT64_MAX;
  for (;;) {
    tfl_charge_result_t r;
    if (g.charge_compute(g.device_index, mflop, &r) != 0) {
      bump(&g.limiter_errors, 1);        /* limiter error: fail open */
      return;
    }
    if (r.allowed) {
      bump(&g.charges, 1);
      bump(&g.charged_mflops, mflop);
      return;
    }
    if (!r.frozen && r.available > 0 && r.available == last_available) {
      tfl_charge_result_t part;
      if (g.charge_compute(g.device_index, r.available, &part) == 0 && part.allowed) {
        bump(&g.charges, 1);
        bump(&g.charged_mflops, r.available);
        mflop -= r.available;
        last_available = UINT64_MAX;
        continue;
      }
    }
    last_available = r.frozen ? UINT64_MAX : r.available;
    uint64_t us = r.wait_hint_us ? r.wait_hint_us : 100;
    if (us > MAX_SLEEP_US) us = MAX_SLEEP_US;
    sleep_us(us);
    bump(&g.blocked_us, us);
  }
}

typedef struct {
  stream_state_t* st;        /* NULL: not metered */
  window_t* window;
  cu_stream_t stream;
  int graph;
  int mark;                  /* record the window's end after this launch */
} launch_t;

static void launch_begin(launch_t* l, cu_stream_t stream, int v, int graph) {
  l->st = NULL;
  if (!metered()) return;
  uintptr_t key;
  cu_stream_t s = normal_stream(stream, v, &key);
  if (capture_forbids_calls() || stream_capturing(s)) {
    bump(&g.captured, 1);
    return;
  }
  pthread_mutex_lock(&g.mu);
  uint64_t due = gather_locked();
  pthread_mutex_unlock(&g.mu);
  pay(due);                          /* outside the lock: it may sleep */

  pthread_mutex_lock(&g.mu);
  stream_state_t* st = stream_locked(key, s);
  if (!st) {
    g.unwindowed++;
    pthread_mutex_unlock(&g.mu);
    return;
  }
  uint64_t now = now_ns();
  int idle = g.stream_query(s) == CU__SUCCESS;
  if (st->open && st->inflight == 0) {
    if (idle) {
      close_drained_locked(st);
    } else if (graph || st->launches >= WINDOW_LAUNCHES ||
               now - st->opened_ns >= WINDOW_US * 1000ull) {
      mark_end_locked(st);           /* exact: the stream is still busy */
      close_open_locked(st, 0);
    }
  }
  if (!st->open) {
    window_t* w = new_window_locked();
    if (w && g.ev_record(w->start, s) != CU__SUCCESS) {
      drop_window_locked(w, 1);      /* perhaps another context's events */
      w = new_window_locked();
      if (w && g.ev_record(w->start, s) != CU__SUCCESS) {
        drop_window_locked(w, 1);
        w = NULL;
      }
    }
    if (!w) {
      g.window_errors++;
      pthread_mutex_unlock(&g.mu);
      return;
    }
    st->open = w;
    st->launches = 0;
    st->since_end = 0;
    st->opened_ns = now;
  }
  st->inflight++;
  st->last_launch_ns = now;
  l->st = st;
  l->window = st->open;
  l->stream = s;
  l->graph = graph;
  /* an end after the first launch of a window, after a launch into an idle
   * stream (the host is behind: nothing queues), after a graph, and every
   * END_EVERY launches; a busy stream is otherwise given no event between
   * its kernels */
  l->mark = idle || graph || st->launches == 0 || (st->launches + 1) % END_EVERY == 0;
  pthread_mutex_unlock(&g.mu);
}

static void launch_end(launch_t* l, cu_result_t r) {
  stream_state_t* st = l->st;
  if (!st) return;
  pthread_mutex_lock(&g.mu);
  st->inflight--;
  if (r == CU__SUCCESS && st->open == l->window) {
    st->launches++;
    st->since_end++;
    if (l->mark) {
      if (g.ev_record(l->window->end, l->stream) == CU__SUCCESS) st->since_end = 0;
      else g.window_errors++;
    }
    g.launches++;
    if (l->graph) g.graph_launches++;
  }
  /* a graph replay is a window of its own (decode steps replay one each) */
  if (l->graph && st->open == l->window && st->inflight == 0) close_open_locked(st, 0);
  pthread_mutex_unlock(&g.mu);
}

/* Before a wait on the host, the windows it waits for get their end, so
 * their last launches are timed exactly. */
static void mark_ends(int all, uintptr_t key) {
  if (!metered() || capture_forbids_calls()) return;
  pthread_mutex_lock(&g.mu);
  for (unsigned i = 0; i < g.n_streams; ++i)
    if (all || g.streams[i].key == key) mark_end_locked(&g.streams[i]);
  pthread_mutex_unlock(&g.mu);
}

#define DEFINE_STREAM_SYNC(V, SUFFIX)                                          \
  HOOK_API cu_result_t cuStreamSynchronize##SUFFIX(STREAM_SYNC_PARAMS) {       \
    bump(&g_entries[E_STREAM_SYNC].calls[V], 1);                               \
    stream_sync_fn real = (stream_sync_fn)real_of(E_STREAM_SYNC, V);           \
    if (!real) return CU__ERROR_NOT_FOUND;                                     \
    uintptr_t key;                                                             \
    normal_stream(s, V, &key);                                                 \
    mark_ends(0, key);                                                         \
    return real(s);                                                            \
  }

DEFINE_STREAM_SYNC(0, )
DEFINE_STREAM_SYNC(1, _ptsz)

/* A destroyed stream's work still runs to its end: its open window gets
 * its end now, and its entry is freed once its windows are read. */
HOOK_API cu_result_t cuStreamDestroy_v2(cu_stream_t s) {
  bump(&g_entries[E_STREAM_DESTROY].calls[0], 1);
  stream_destroy_fn real = (stream_destroy_fn)real_of(E_STREAM_DESTROY, 0);
  if (!real) return CU__ERROR_NOT_FOUND;
  if (s && metered()) {
    int forbidden = capture_forbids_calls();
    pthread_mutex_lock(&g.mu);
    for (unsigned i = 0; i < g.n_streams; ++i) {
      stream_state_t* st = &g.streams[i];
      if (st->key != (uintptr_t)s) continue;
      if (!forbidden) mark_end_locked(st);
      g.untimed += st->since_end;    /* its end could not be recorded */
      st->since_end = 0;
      close_open_locked(st, 0);
      st->key = 0;
      g.streams_dropped++;
      break;
    }
    pthread_mutex_unlock(&g.mu);
  }
  return real(s);
}

HOOK_API cu_result_t cuCtxSynchronize(void) {
  bump(&g_entries[E_CTX_SYNC].calls[0], 1);
  ctx_sync_fn real = (ctx_sync_fn)real_of(E_CTX_SYNC, 0);
  if (!real) return CU__ERROR_NOT_FOUND;
  mark_ends(1, 0);
  return real();
}

#define LAUNCH_BODY(E, V, TYPE, STREAM, GRAPH, ...)                    \
  bump(&g_entries[E].calls[V], 1);                                      \
  TYPE real = (TYPE)real_of(E, V);                                      \
  if (!real) return CU__ERROR_NOT_FOUND;                                \
  launch_t l;                                                           \
  launch_begin(&l, STREAM, V, GRAPH);                                   \
  cu_result_t r = real(__VA_ARGS__);                                    \
  launch_end(&l, r);                                                    \
  return r;

#define DEFINE_LAUNCHES(V, SUFFIX)                                                     \
  HOOK_API cu_result_t cuLaunchKernel##SUFFIX(LAUNCH_KERNEL_PARAMS) {                  \
    LAUNCH_BODY(E_LAUNCH_KERNEL, V, launch_kernel_fn, s, 0, f, gx, gy, gz, bx, by, bz, \
                smem, s, params, extra)                                                \
  }                                                                                    \
  HOOK_API cu_result_t cuLaunchKernelEx##SUFFIX(LAUNCH_KERNEL_EX_PARAMS) {             \
    LAUNCH_BODY(E_LAUNCH_KERNEL_EX, V, launch_kernel_ex_fn, c ? c->hStream : NULL, 0,  \
                c, f, params, extra)                                                   \
  }                                                                                    \
  HOOK_API cu_result_t cuLaunchCooperativeKernel##SUFFIX(LAUNCH_COOP_PARAMS) {         \
    LAUNCH_BODY(E_LAUNCH_COOPERATIVE, V, launch_coop_fn, s, 0, f, gx, gy, gz, bx, by,  \
                bz, smem, s, params)                                                   \
  }                                                                                    \
  HOOK_API cu_result_t cuGraphLaunch##SUFFIX(GRAPH_LAUNCH_PARAMS) {                    \
    LAUNCH_BODY(E_GRAPH_LAUNCH, V, graph_launch_fn, s, 1, exec, s)                     \
  }

DEFINE_LAUNCHES(0, )
DEFINE_LAUNCHES(1, _ptsz)

/* ------------------------------------------------------------------ */
/* capture                                                             */
/* ------------------------------------------------------------------ */

static void capture_began(cu_result_t r, cu_stream_t s, int v, cu_capture_mode_t mode) {
  if (r != CU__SUCCESS) return;
  uintptr_t key;
  s = normal_stream(s, v, &key);
  pthread_mutex_lock(&g.mu);
  if (g.n_capturing < MAX_CAPTURES)
    g.capturing[g.n_capturing++] = (capture_t){s, mode, pthread_self()};
  pthread_mutex_unlock(&g.mu);
}

/* A capture has ended when its stream no longer captures after the call
 * (an invalidated capture ends with an error). */
static cu_result_t end_capture(int v, cu_stream_t s, cu_graph_t* graph) {
  bump(&g_entries[E_END_CAPTURE].calls[v], 1);
  end_capture_fn real = (end_capture_fn)real_of(E_END_CAPTURE, v);
  if (!real) return CU__ERROR_NOT_FOUND;
  cu_result_t r = real(s, graph);
  stream_is_capturing_fn is_capturing = g.is_capturing;
  if (!is_capturing) {
    void* h = libcuda();
    if (h) is_capturing = (stream_is_capturing_fn)g.real_dlsym(h, "cuStreamIsCapturing");
  }
  uintptr_t key;
  cu_stream_t ns = normal_stream(s, v, &key);
  cu_capture_status_t cs = CU__STREAM_CAPTURE_STATUS_ACTIVE;
  if (is_capturing && is_capturing(ns, &cs) == CU__SUCCESS &&
      cs == CU__STREAM_CAPTURE_STATUS_NONE) {
    pthread_mutex_lock(&g.mu);
    for (int i = 0; i < g.n_capturing; ++i)
      if (g.capturing[i].stream == ns) {
        g.capturing[i] = g.capturing[--g.n_capturing];
        break;
      }
    pthread_mutex_unlock(&g.mu);
  }
  return r;
}

#define DEFINE_CAPTURE(V, SUFFIX)                                                      \
  HOOK_API cu_result_t cuStreamBeginCapture_v2##SUFFIX(BEGIN_CAPTURE_PARAMS) {         \
    bump(&g_entries[E_BEGIN_CAPTURE].calls[V], 1);                                     \
    begin_capture_fn real = (begin_capture_fn)real_of(E_BEGIN_CAPTURE, V);             \
    if (!real) return CU__ERROR_NOT_FOUND;                                             \
    cu_result_t r = real(s, mode);                                                     \
    capture_began(r, s, V, mode);                                                      \
    return r;                                                                          \
  }                                                                                    \
  HOOK_API cu_result_t cuStreamBeginCaptureToGraph##SUFFIX(BEGIN_CAPTURE_TO_GRAPH_PARAMS) { \
    bump(&g_entries[E_BEGIN_CAPTURE_TO_GRAPH].calls[V], 1);                            \
    begin_capture_to_graph_fn real =                                                   \
        (begin_capture_to_graph_fn)real_of(E_BEGIN_CAPTURE_TO_GRAPH, V);               \
    if (!real) return CU__ERROR_NOT_FOUND;                                             \
    cu_result_t r = real(s, graph, deps, edges, n, mode);                              \
    capture_began(r, s, V, mode);                                                      \
    return r;                                                                          \
  }                                                                                    \
  HOOK_API cu_result_t cuStreamEndCapture##SUFFIX(END_CAPTURE_PARAMS) {                \
    return end_capture(V, s, graph);                                                   \
  }

DEFINE_CAPTURE(0, )
DEFINE_CAPTURE(1, _ptsz)

/* ------------------------------------------------------------------ */
/* memory (pjrt_proxy.cc charge_buffer / proxy_buffer_destroy)         */
/* ------------------------------------------------------------------ */

static uint64_t mix(uint64_t k) {
  k ^= k >> 33;
  k *= 0xff51afd7ed558ccdull;
  k ^= k >> 33;
  return k;
}

static mem_slot_t* mem_find_locked(uint64_t key, uint8_t kind, int insert) {
  if (insert && (g.mem_used + 1) * 2 > g.mem_cap) {
    size_t cap = g.mem_cap ? g.mem_cap * 2 : 1024;
    mem_slot_t* slots = calloc(cap, sizeof(*slots));
    if (!slots) return NULL;
    size_t used = 0;
    for (size_t i = 0; i < g.mem_cap; ++i) {
      if (g.mem[i].state != 1) continue;
      size_t j = mix(g.mem[i].key ^ g.mem[i].kind) & (cap - 1);
      while (slots[j].state) j = (j + 1) & (cap - 1);
      slots[j] = g.mem[i];
      used++;
    }
    free(g.mem);
    g.mem = slots;
    g.mem_cap = cap;
    g.mem_used = used;
  }
  if (!g.mem_cap) return NULL;
  size_t j = mix(key ^ kind) & (g.mem_cap - 1);
  mem_slot_t* grave = NULL;
  for (size_t probes = 0; probes < g.mem_cap; ++probes, j = (j + 1) & (g.mem_cap - 1)) {
    mem_slot_t* s = &g.mem[j];
    if (s->state == 0) {
      if (!insert) return NULL;
      if (!grave) {
        grave = s;
        g.mem_used++;
      }
      return grave;
    }
    if (s->state == 2) {
      if (!grave) grave = s;
    } else if (s->key == key && s->kind == kind) {
      return s;
    }
  }
  return insert ? grave : NULL;
}

static void charge_memory(uint8_t kind, uint64_t key, size_t size) {
  if (size == 0 || !metered()) return;
  tfl_charge_result_t r;
  uint8_t admitted = 0;
  if (g.charge_hbm(g.device_index, (int64_t)size, &r) == 0) {
    admitted = r.allowed;
    if (!r.allowed) {
      bump(&g.hbm_denied, 1);
      logmsg("device memory budget exceeded (accounted)");
    }
  } else {
    bump(&g.limiter_errors, 1);
  }
  __atomic_add_fetch(&g.hbm_charged_bytes, (int64_t)size, __ATOMIC_RELAXED);
  pthread_mutex_lock(&g.mu);
  mem_slot_t* s = mem_find_locked(key, kind, 1);
  if (s) {
    if (s->state == 1 && s->admitted) {  /* a stale entry: its free was not seen */
      tfl_charge_result_t rr;
      g.charge_hbm(g.device_index, -(int64_t)s->size, &rr);
      __atomic_sub_fetch(&g.hbm_charged_bytes, (int64_t)s->size, __ATOMIC_RELAXED);
    } else if (s->state == 1) {
      __atomic_sub_fetch(&g.hbm_charged_bytes, (int64_t)s->size, __ATOMIC_RELAXED);
    }
    s->key = key;
    s->kind = kind;
    s->size = size;
    s->admitted = admitted;
    s->state = 1;
  }
  pthread_mutex_unlock(&g.mu);
}

static void release_memory(uint8_t kind, uint64_t key) {
  if (!metered()) return;
  pthread_mutex_lock(&g.mu);
  mem_slot_t* s = mem_find_locked(key, kind, 0);
  uint64_t size = 0;
  uint8_t admitted = 0;
  if (s) {
    size = s->size;
    admitted = s->admitted;
    s->state = 2;
  }
  pthread_mutex_unlock(&g.mu);
  if (!size) return;
  if (admitted) {
    tfl_charge_result_t r;
    if (g.charge_hbm(g.device_index, -(int64_t)size, &r) != 0) bump(&g.limiter_errors, 1);
  }
  __atomic_sub_fetch(&g.hbm_charged_bytes, (int64_t)size, __ATOMIC_RELAXED);
}

#define KIND_PTR 0
#define KIND_HANDLE 1

HOOK_API cu_result_t cuMemAlloc_v2(cu_deviceptr_t* dptr, size_t size) {
  bump(&g_entries[E_MEM_ALLOC].calls[0], 1);
  mem_alloc_fn real = (mem_alloc_fn)real_of(E_MEM_ALLOC, 0);
  if (!real) return CU__ERROR_NOT_FOUND;
  cu_result_t r = real(dptr, size);
  if (r == CU__SUCCESS && dptr) charge_memory(KIND_PTR, *dptr, size);
  return r;
}

HOOK_API cu_result_t cuMemCreate(cu_mem_handle_t* handle, size_t size,
                                 const cu_mem_allocation_prop_t* prop, unsigned long long flags) {
  bump(&g_entries[E_MEM_CREATE].calls[0], 1);
  mem_create_fn real = (mem_create_fn)real_of(E_MEM_CREATE, 0);
  if (!real) return CU__ERROR_NOT_FOUND;
  cu_result_t r = real(handle, size, prop, flags);
  if (r == CU__SUCCESS && handle) charge_memory(KIND_HANDLE, *handle, size);
  return r;
}

/* released before the driver frees, so an address the driver hands out
 * again is never released on behalf of its earlier owner */
HOOK_API cu_result_t cuMemFree_v2(cu_deviceptr_t dptr) {
  bump(&g_entries[E_MEM_FREE].calls[0], 1);
  mem_free_fn real = (mem_free_fn)real_of(E_MEM_FREE, 0);
  if (!real) return CU__ERROR_NOT_FOUND;
  release_memory(KIND_PTR, dptr);
  return real(dptr);
}

HOOK_API cu_result_t cuMemRelease(cu_mem_handle_t handle) {
  bump(&g_entries[E_MEM_RELEASE].calls[0], 1);
  mem_release_fn real = (mem_release_fn)real_of(E_MEM_RELEASE, 0);
  if (!real) return CU__ERROR_NOT_FOUND;
  release_memory(KIND_HANDLE, handle);
  return real(handle);
}

#define DEFINE_ASYNC_MEMORY(V, SUFFIX)                                                   \
  HOOK_API cu_result_t cuMemAllocAsync##SUFFIX(MEM_ALLOC_ASYNC_PARAMS) {                 \
    bump(&g_entries[E_MEM_ALLOC_ASYNC].calls[V], 1);                                     \
    mem_alloc_async_fn real = (mem_alloc_async_fn)real_of(E_MEM_ALLOC_ASYNC, V);         \
    if (!real) return CU__ERROR_NOT_FOUND;                                               \
    cu_result_t r = real(dptr, size, s);                                                 \
    if (r == CU__SUCCESS && dptr) charge_memory(KIND_PTR, *dptr, size);                  \
    return r;                                                                            \
  }                                                                                      \
  HOOK_API cu_result_t cuMemAllocFromPoolAsync##SUFFIX(MEM_ALLOC_POOL_ASYNC_PARAMS) {    \
    bump(&g_entries[E_MEM_ALLOC_POOL_ASYNC].calls[V], 1);                                \
    mem_alloc_pool_async_fn real =                                                       \
        (mem_alloc_pool_async_fn)real_of(E_MEM_ALLOC_POOL_ASYNC, V);                     \
    if (!real) return CU__ERROR_NOT_FOUND;                                               \
    cu_result_t r = real(dptr, size, pool, s);                                           \
    if (r == CU__SUCCESS && dptr) charge_memory(KIND_PTR, *dptr, size);                  \
    return r;                                                                            \
  }                                                                                      \
  HOOK_API cu_result_t cuMemFreeAsync##SUFFIX(MEM_FREE_ASYNC_PARAMS) {                   \
    bump(&g_entries[E_MEM_FREE_ASYNC].calls[V], 1);                                      \
    mem_free_async_fn real = (mem_free_async_fn)real_of(E_MEM_FREE_ASYNC, V);            \
    if (!real) return CU__ERROR_NOT_FOUND;                                               \
    release_memory(KIND_PTR, dptr);                                                      \
    return real(dptr, s);                                                                \
  }

DEFINE_ASYNC_MEMORY(0, )
DEFINE_ASYNC_MEMORY(1, _ptsz)

/* ------------------------------------------------------------------ */
/* introspection (pjrt_proxy.cc tpf_proxy_stats / tpf_proxy_metered)   */
/* ------------------------------------------------------------------ */

HOOK_API void tpf_cuda_hook_stats(uint64_t* launches, uint64_t* charged_mflops,
                                  uint64_t* blocked_us, int64_t* hbm_charged_bytes,
                                  uint64_t* hbm_denied, uint64_t* device_us) {
  if (launches) *launches = __atomic_load_n(&g.launches, __ATOMIC_RELAXED);
  if (charged_mflops) *charged_mflops = __atomic_load_n(&g.charged_mflops, __ATOMIC_RELAXED);
  if (blocked_us) *blocked_us = __atomic_load_n(&g.blocked_us, __ATOMIC_RELAXED);
  if (hbm_charged_bytes)
    *hbm_charged_bytes = __atomic_load_n(&g.hbm_charged_bytes, __ATOMIC_RELAXED);
  if (hbm_denied) *hbm_denied = __atomic_load_n(&g.hbm_denied, __ATOMIC_RELAXED);
  if (device_us) *device_us = __atomic_load_n(&g.device_ns, __ATOMIC_RELAXED) / 1000;
}

HOOK_API uint8_t tpf_cuda_hook_metered(void) { return metered() ? 1 : 0; }

HOOK_API uint8_t tpf_cuda_hook_frozen(void) {
  return metered() && g.worker_frozen && g.worker_frozen() ? 1 : 0;
}

/* Everything the hook counts, as one JSON object: the totals, its
 * settings, and the calls that reached each entry (by exported name). */
HOOK_API int tpf_cuda_hook_report(char* buf, size_t len) {
  size_t n = 0;
#define PUT(...)                                                   \
  do {                                                             \
    int w = snprintf(buf + n, n < len ? len - n : 0, __VA_ARGS__); \
    if (w < 0) return -1;                                          \
    n += (size_t)w;                                                \
  } while (0)
#define LOAD(x) (unsigned long long)__atomic_load_n(&g.x, __ATOMIC_RELAXED)
  PUT("{\"metered\": %d, \"peak_mflops\": %.17g, ", g.metered, g.peak_mflops);
  PUT("\"launches\": %llu, \"graph_launches\": %llu, \"charges\": %llu, "
      "\"charged_mflops\": %llu, \"device_us\": %llu, \"blocked_us\": %llu, "
      "\"hbm_charged_bytes\": %lld, \"hbm_denied\": %llu, \"captured\": %llu, "
      "\"windows\": %llu, \"window_errors\": %llu, \"unwindowed\": %llu, \"untimed\": %llu, "
      "\"streams_dropped\": %llu, \"limiter_errors\": %llu, \"wrapped_by_gpa\": %llu, "
      "\"wrapped_by_dlsym\": %llu, \"entries\": {",
      LOAD(launches), LOAD(graph_launches), LOAD(charges), LOAD(charged_mflops),
      LOAD(device_ns) / 1000, LOAD(blocked_us),
      (long long)__atomic_load_n(&g.hbm_charged_bytes, __ATOMIC_RELAXED), LOAD(hbm_denied),
      LOAD(captured), LOAD(windows), LOAD(window_errors), LOAD(unwindowed), LOAD(untimed),
      LOAD(streams_dropped), LOAD(limiter_errors), LOAD(wrapped_by_gpa),
      LOAD(wrapped_by_dlsym));
  const char* sep = "";
  for (int e = 0; e < N_ENTRIES; ++e)
    for (int v = 0; v < 2; ++v) {
      if (!g_entries[e].exported[v]) continue;
      PUT("%s\"%s\": %llu", sep, g_entries[e].exported[v],
          (unsigned long long)__atomic_load_n(&g_entries[e].calls[v], __ATOMIC_RELAXED));
      sep = ", ";
    }
  PUT("}}");
#undef LOAD
#undef PUT
  return n < len ? (int)n : -1;
}
