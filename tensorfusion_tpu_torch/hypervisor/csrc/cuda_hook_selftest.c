/*
 * Selftest of libtpf_cuda_hook.so: mandatory metering of an unmodified
 * CUDA process (the counterpart of native/test/pjrt_proxy_selftest.cc and,
 * with --bench, of pjrt_proxy_bench.cc).
 *
 * It reaches the driver exactly as CUDA 12's runtime does:
 * dlopen("libcuda.so.1"), dlsym(handle, "cuGetProcAddress_v2"), then every
 * entry from that table, with the hook in LD_PRELOAD and the stand-in
 * driver (fake_cuda.c) as libcuda.so.1.  The worker's shm segment is made
 * through the limiter's hypervisor face, as the node agent makes it:
 *
 *   LD_PRELOAD=libtpf_cuda_hook.so LD_LIBRARY_PATH=<dir of the fake> \
 *     cuda_hook_selftest <limiter.so> <shm_base> <case>
 *
 * Cases (one process each, since the hook attaches once):
 *   block        a rate-limited quota makes a burst of launches block
 *                (wall clock and blocked_us);
 *   charge       the charge is the device time times TPF_PEAK_MFLOPS, for
 *                every launch entry and both stream variants;
 *   window       a busy stream's window closes after 64 launches (or 2 ms
 *                of host time), and is read only once it has completed;
 *   sync         a synchronize ends the windows it waits for, so their
 *                last launches are timed; a stream that drained unseen
 *                ends its window at its last end, the launches after it
 *                untimed;
 *   capture      a launch on a capturing stream is not charged and gets no
 *                event, nor does any launch during a global-mode capture;
 *                a graph launch is charged its own window;
 *   capture_modes during a relaxed capture, or a thread-local one of
 *                another thread, launches on other streams are charged;
 *   streams      a process that creates and destroys more streams than the
 *                hook's table holds has every launch timed;
 *   memory       alloc, async alloc and cuMemCreate charge device memory,
 *                their frees release it, an allocation over the budget is
 *                counted and never released from the segment;
 *   passthrough  with no TPF_SHM_PATH every call reaches the driver and
 *                nothing is charged;
 *   freeze       a frozen worker's launch blocks until it is thawed;
 *   rtld_next    dlsym(RTLD_NEXT, ...) still resolves relative to its
 *                caller;
 *   --bench      the hook's cost per launch against the driver's own entry
 *                (uncontended quota), one JSON line.
 *
 * Each case prints "PASS <case>: ..." and, last, the hook's report.
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

typedef int32_t tpf_status_t;
typedef struct {
  uint32_t device_index;
  char chip_id[64];
  uint32_t duty_limit_bp;
  uint64_t hbm_limit_bytes;
  uint64_t capacity_mflop;
  uint64_t refill_mflop_per_s;
} tfl_device_quota_t;
typedef struct {
  uint8_t allowed;
  uint8_t frozen;
  uint64_t available;
  uint64_t wait_hint_us;
} tfl_charge_result_t;

typedef cu_result_t (*launch_kernel_fn)(cu_function_t, unsigned, unsigned, unsigned, unsigned,
                                        unsigned, unsigned, unsigned, cu_stream_t, void**,
                                        void**);
typedef cu_result_t (*launch_kernel_ex_fn)(const cu_launch_config_t*, cu_function_t, void**,
                                           void**);
typedef cu_result_t (*launch_coop_fn)(cu_function_t, unsigned, unsigned, unsigned, unsigned,
                                      unsigned, unsigned, unsigned, cu_stream_t, void**);
typedef cu_result_t (*graph_launch_fn)(cu_graph_exec_t, cu_stream_t);
typedef cu_result_t (*mem_alloc_fn)(cu_deviceptr_t*, size_t);
typedef cu_result_t (*mem_alloc_async_fn)(cu_deviceptr_t*, size_t, cu_stream_t);
typedef cu_result_t (*mem_create_fn)(cu_mem_handle_t*, size_t, const cu_mem_allocation_prop_t*,
                                     unsigned long long);
typedef cu_result_t (*mem_free_fn)(cu_deviceptr_t);
typedef cu_result_t (*mem_free_async_fn)(cu_deviceptr_t, cu_stream_t);
typedef cu_result_t (*mem_release_fn)(cu_mem_handle_t);
typedef cu_result_t (*begin_capture_fn)(cu_stream_t, cu_capture_mode_t);
typedef cu_result_t (*end_capture_fn)(cu_stream_t, cu_graph_t*);
typedef cu_result_t (*stream_sync_fn)(cu_stream_t);
typedef cu_result_t (*stream_destroy_fn)(cu_stream_t);
typedef cu_result_t (*ctx_sync_fn)(void);
typedef cu_result_t (*gpa_v2_fn)(const char*, void**, int, cu_uint64_t, cu_proc_query_result_t*);
typedef void (*stats_fn)(uint64_t*, uint64_t*, uint64_t*, int64_t*, uint64_t*, uint64_t*);
typedef int (*report_fn)(char*, size_t);
typedef uint64_t (*fake_count_fn)(const char*);

#define CHECK(cond)                                                   \
  do {                                                                \
    if (!(cond)) {                                                    \
      fprintf(stderr, "FAIL %s:%d: %s\n", __FILE__, __LINE__, #cond); \
      exit(1);                                                        \
    }                                                                 \
  } while (0)

#define CUDA_VERSION_ASKED 12080  /* what a CUDA 12.8 runtime asks for */
#define MIB (1ull << 20)

static double now_s(void) {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (double)ts.tv_sec + (double)ts.tv_nsec / 1e9;
}

static struct {
  void* limiter;
  tpf_status_t (*init)(const char*);
  tpf_status_t (*create_worker)(const char*, const char*, const tfl_device_quota_t*, size_t);
  tpf_status_t (*set_frozen)(const char*, const char*, uint8_t, uint8_t);
  tpf_status_t (*charge_hbm)(uint32_t, int64_t, tfl_charge_result_t*);
  void* cuda;
  gpa_v2_fn gpa;
  fake_count_fn fake_count;
  stats_fn stats;
  report_fn report;
} t;

typedef struct {
  uint64_t launches, charged_mflops, blocked_us, hbm_denied, device_us;
  int64_t hbm_charged_bytes;
} stats_t;

static stats_t stats(void) {
  stats_t s;
  t.stats(&s.launches, &s.charged_mflops, &s.blocked_us, &s.hbm_charged_bytes, &s.hbm_denied,
          &s.device_us);
  return s;
}

static void* proc(const char* name, cu_uint64_t flags) {
  void* p = NULL;
  cu_proc_query_result_t st = -1;
  CHECK(t.gpa(name, &p, CUDA_VERSION_ASKED, flags, &st) == CU__SUCCESS);
  CHECK(st == CU__GET_PROC_ADDRESS_SUCCESS && p != NULL);
  return p;
}

/* the worker's segment, as the node agent makes it; the worker face then
 * finds it through the environment */
static void make_worker(const char* limiter_path, const char* shm_base, uint64_t hbm_limit,
                        uint64_t capacity, uint64_t refill) {
  CHECK(t.init(shm_base) == 0);
  tfl_device_quota_t q;
  memset(&q, 0, sizeof(q));
  snprintf(q.chip_id, sizeof(q.chip_id), "fake-gpu");
  q.duty_limit_bp = 10000;
  q.hbm_limit_bytes = hbm_limit;
  q.capacity_mflop = capacity;
  q.refill_mflop_per_s = refill;
  CHECK(t.create_worker("t", "w", &q, 1) == 0);
  char path[512];
  snprintf(path, sizeof(path), "%s/t/w", shm_base);
  setenv("TPF_SHM_PATH", path, 1);
  setenv("TPF_LIMITER_LIB", limiter_path, 1);
}

static void open_libraries(const char* limiter_path) {
  t.limiter = dlopen(limiter_path, RTLD_NOW);
  CHECK(t.limiter != NULL);
  t.init = dlsym(t.limiter, "tfl_init");
  t.create_worker = dlsym(t.limiter, "tfl_create_worker");
  t.set_frozen = dlsym(t.limiter, "tfl_set_frozen");
  t.charge_hbm = dlsym(t.limiter, "tfl_charge_hbm");
  CHECK(t.init && t.create_worker && t.set_frozen && t.charge_hbm);
  /* the hook must be preloaded: its introspection is in the global scope */
  t.stats = (stats_fn)dlsym(RTLD_DEFAULT, "tpf_cuda_hook_stats");
  t.report = (report_fn)dlsym(RTLD_DEFAULT, "tpf_cuda_hook_report");
  CHECK(t.stats != NULL && t.report != NULL);
}

/* cudart's way in: the table, from a dlsym on its own libcuda handle */
static void open_driver(void) {
  t.cuda = dlopen("libcuda.so.1", RTLD_NOW);
  CHECK(t.cuda != NULL);
  t.gpa = (gpa_v2_fn)dlsym(t.cuda, "cuGetProcAddress_v2");
  t.fake_count = (fake_count_fn)dlsym(t.cuda, "tpf_fake_cuda_count");
  CHECK(t.gpa != NULL && t.fake_count != NULL);
  /* what came back is the hook's, not the driver's own */
  void* hooks = dlsym(RTLD_DEFAULT, "tpf_cuda_hook_report");
  Dl_info a, b;
  CHECK(dladdr((void*)t.gpa, &a) && dladdr(hooks, &b) && strcmp(a.dli_fname, b.dli_fname) == 0);
}

static uint8_t hook_metered(void) {
  uint8_t (*fn)(void) = (uint8_t(*)(void))dlsym(RTLD_DEFAULT, "tpf_cuda_hook_metered");
  CHECK(fn != NULL);
  return fn();
}

static void print_report(void) {
  char buf[8192];
  CHECK(t.report(buf, sizeof(buf)) > 0);
  printf("%s\n", buf);
}

#define LAUNCH(fn, stream) fn(NULL, 1, 1, 1, 32, 1, 1, 0, stream, NULL, NULL)
#define S(x) ((cu_stream_t)(uintptr_t)(x))

static int case_block(void) {
  /* 100 MFLOP a launch (1 ms at 1e5 MFLOP/s), 200 of burst, 1000 a second */
  launch_kernel_fn launch = proc("cuLaunchKernel", CU__GET_PROC_ADDRESS_DEFAULT);
  CHECK(hook_metered() == 1);
  const int n = 11;                  /* the 11th pays for the 10th */
  double t0 = now_s();
  for (int i = 0; i < n; ++i) CHECK(LAUNCH(launch, S(0x100)) == CU__SUCCESS);
  double elapsed = now_s() - t0;
  stats_t s = stats();
  CHECK(s.launches == (uint64_t)n);
  CHECK(s.charged_mflops == 1000);
  CHECK(s.device_us == 10000);
  CHECK(s.blocked_us > 0);
  CHECK(elapsed > 0.5);              /* 1000 - 200 at 1000/s: ~0.8 s */
  CHECK(t.fake_count("launch") == (uint64_t)n);
  printf("PASS block: %d launches metered (%.2fs wall, %llums blocked)\n", n, elapsed,
         (unsigned long long)(s.blocked_us / 1000));
  return 0;
}

static int case_charge(void) {
  /* every entry and both stream variants, 250 us each at 989e6 MFLOP/s */
  launch_kernel_fn launch = proc("cuLaunchKernel", CU__GET_PROC_ADDRESS_LEGACY_STREAM);
  launch_kernel_fn launch_ptsz =
      proc("cuLaunchKernel", CU__GET_PROC_ADDRESS_PER_THREAD_DEFAULT_STREAM);
  launch_kernel_ex_fn launch_ex = proc("cuLaunchKernelEx", CU__GET_PROC_ADDRESS_DEFAULT);
  launch_coop_fn coop = proc("cuLaunchCooperativeKernel", CU__GET_PROC_ADDRESS_DEFAULT);
  CHECK((void*)launch != (void*)launch_ptsz);
  CHECK((void*)launch == dlsym(RTLD_DEFAULT, "cuLaunchKernel"));
  CHECK((void*)launch_ptsz == dlsym(RTLD_DEFAULT, "cuLaunchKernel_ptsz"));
  CHECK(hook_metered() == 1);
  cu_launch_config_t config;
  memset(&config, 0, sizeof(config));
  config.gridDimX = config.gridDimY = config.gridDimZ = 1;
  config.blockDimX = 32;
  config.blockDimY = config.blockDimZ = 1;
  config.hStream = S(0x300);
  int n = 0;
  for (int i = 0; i < 20; ++i, ++n) CHECK(LAUNCH(launch, S(0x100)) == CU__SUCCESS);
  for (int i = 0; i < 20; ++i, ++n) CHECK(LAUNCH(launch_ptsz, NULL) == CU__SUCCESS);
  for (int i = 0; i < 5; ++i, ++n) CHECK(launch_ex(&config, NULL, NULL, NULL) == CU__SUCCESS);
  for (int i = 0; i < 5; ++i, ++n)
    CHECK(coop(NULL, 1, 1, 1, 32, 1, 1, 0, S(0x400), NULL) == CU__SUCCESS);
  stats_t s = stats();
  /* the last launch's window is read at the next launch */
  uint64_t device_us = (uint64_t)(n - 1) * 250;
  CHECK(s.launches == (uint64_t)n);
  CHECK(s.device_us == device_us);
  CHECK(s.charged_mflops == device_us * 989);     /* 989e6 MFLOP/s = 989 a us */
  CHECK(t.fake_count("clock_us") == (uint64_t)n * 250);
  printf("PASS charge: %d launches, %llu us charged %llu MFLOP\n", n,
         (unsigned long long)s.device_us, (unsigned long long)s.charged_mflops);
  return 0;
}

static unsigned long long report_field(const char* name) {
  char buf[8192], key[64];
  CHECK(t.report(buf, sizeof(buf)) > 0);
  snprintf(key, sizeof(key), "\"%s\": ", name);
  const char* at = strstr(buf, key);
  CHECK(at != NULL);
  return strtoull(at + strlen(key), NULL, 10);
}

static int case_window(void) {
  /* events complete 2 launches late: the stream is never seen idle */
  launch_kernel_fn launch = proc("cuLaunchKernel", CU__GET_PROC_ADDRESS_DEFAULT);
  CHECK(hook_metered() == 1);
  for (int i = 0; i < 140; ++i) CHECK(LAUNCH(launch, S(0x100)) == CU__SUCCESS);
  stats_t s = stats();
  /* windows of at most 64 launches (fewer where 2 ms of host time went by
   * first): 1-64 and 65-128 at least are read; launches 139 and 140 have
   * not completed, so no window holding them is */
  CHECK(report_field("windows") >= 2);
  CHECK(s.device_us >= 128 * 1000 && s.device_us <= 138 * 1000);
  CHECK(s.launches == 140);
  printf("PASS window: %llu windows read, %llu us\n", report_field("windows"),
         (unsigned long long)s.device_us);
  return 0;
}

static int case_sync(void) {
  /* events and streams complete 3 launches late, or at a synchronize */
  launch_kernel_fn launch = proc("cuLaunchKernel", CU__GET_PROC_ADDRESS_DEFAULT);
  stream_sync_fn stream_sync = proc("cuStreamSynchronize", CU__GET_PROC_ADDRESS_DEFAULT);
  ctx_sync_fn ctx_sync = proc("cuCtxSynchronize", CU__GET_PROC_ADDRESS_DEFAULT);
  void (*drain)(void) = (void (*)(void))dlsym(t.cuda, "tpf_fake_cuda_drain");
  CHECK(drain != NULL && (void*)ctx_sync == dlsym(RTLD_DEFAULT, "cuCtxSynchronize"));
  CHECK(hook_metered() == 1);
  char buf[8192];
  for (int i = 0; i < 10; ++i) CHECK(LAUNCH(launch, S(0x100)) == CU__SUCCESS);
  CHECK(stream_sync(S(0x100)) == CU__SUCCESS);
  CHECK(LAUNCH(launch, S(0x100)) == CU__SUCCESS);          /* 11: reads 1-10 */
  CHECK(stats().device_us == 10 * 1000);
  for (int i = 0; i < 9; ++i) CHECK(LAUNCH(launch, S(0x100)) == CU__SUCCESS);
  drain();                                                   /* unseen */
  CHECK(LAUNCH(launch, S(0x100)) == CU__SUCCESS);          /* 21: 11 timed, 12-20 not */
  CHECK(stats().device_us == 11 * 1000);
  CHECK(t.report(buf, sizeof(buf)) > 0 && strstr(buf, "\"untimed\": 9,") != NULL);
  for (int i = 0; i < 4; ++i) CHECK(LAUNCH(launch, S(0x100)) == CU__SUCCESS);
  CHECK(ctx_sync() == CU__SUCCESS);
  CHECK(LAUNCH(launch, S(0x100)) == CU__SUCCESS);          /* 26: reads 21-25 */
  stats_t s = stats();
  CHECK(s.device_us == 16 * 1000 && s.launches == 26);
  CHECK(t.fake_count("sync") == 2);
  printf("PASS sync: synchronizes end their windows, 9 launches after a drain untimed\n");
  return 0;
}

static int case_capture(void) {
  launch_kernel_fn launch = proc("cuLaunchKernel", CU__GET_PROC_ADDRESS_DEFAULT);
  graph_launch_fn graph = proc("cuGraphLaunch", CU__GET_PROC_ADDRESS_DEFAULT);
  begin_capture_fn begin = proc("cuStreamBeginCapture", CU__GET_PROC_ADDRESS_DEFAULT);
  end_capture_fn end = proc("cuStreamEndCapture", CU__GET_PROC_ADDRESS_DEFAULT);
  CHECK(hook_metered() == 1);
  uint64_t records = t.fake_count("event_record");
  CHECK(begin(S(0x500), 0) == CU__SUCCESS);
  CHECK(LAUNCH(launch, S(0x500)) == CU__SUCCESS);   /* recorded into the graph */
  CHECK(LAUNCH(launch, S(0x600)) == CU__SUCCESS);   /* another stream, meanwhile */
  cu_graph_t g = NULL;
  CHECK(end(S(0x500), &g) == CU__SUCCESS && g != NULL);
  CHECK(t.fake_count("capture_event_record") == 0);
  CHECK(t.fake_count("event_record") == records);   /* no event while capturing */
  CHECK(t.fake_count("captured_launch") == 1);
  stats_t s = stats();
  CHECK(s.launches == 0 && s.device_us == 0);
  /* the graph (1000 us), then two kernels (100 us each) */
  CHECK(graph((cu_graph_exec_t)0x77, S(0x600)) == CU__SUCCESS);
  CHECK(LAUNCH(launch, S(0x600)) == CU__SUCCESS);
  CHECK(LAUNCH(launch, S(0x600)) == CU__SUCCESS);
  s = stats();
  CHECK(s.launches == 3);
  CHECK(s.device_us == 1100);
  CHECK(t.fake_count("graph_launch") == 1);
  char buf[8192];
  CHECK(t.report(buf, sizeof(buf)) > 0);
  CHECK(strstr(buf, "\"graph_launches\": 1,") && strstr(buf, "\"captured\": 2,"));
  printf("PASS capture: 2 launches under capture uncharged, graph charged %llu us\n",
         (unsigned long long)s.device_us);
  return 0;
}

static launch_kernel_fn g_launch;
static uint64_t g_other_thread_launches;

static void* launch_on_0x600(void* arg) {
  (void)arg;
  uint64_t before = stats().launches;
  CHECK(LAUNCH(g_launch, S(0x600)) == CU__SUCCESS);
  g_other_thread_launches = stats().launches - before;
  return NULL;
}

static int case_capture_modes(void) {
  g_launch = proc("cuLaunchKernel", CU__GET_PROC_ADDRESS_DEFAULT);
  begin_capture_fn begin = proc("cuStreamBeginCapture", CU__GET_PROC_ADDRESS_DEFAULT);
  end_capture_fn end = proc("cuStreamEndCapture", CU__GET_PROC_ADDRESS_DEFAULT);
  CHECK(hook_metered() == 1);
  cu_graph_t g = NULL;
  /* relaxed: only the capturing stream's own launch goes uncharged */
  CHECK(begin(S(0x500), CU__STREAM_CAPTURE_MODE_RELAXED) == CU__SUCCESS);
  CHECK(LAUNCH(g_launch, S(0x500)) == CU__SUCCESS);
  CHECK(LAUNCH(g_launch, S(0x600)) == CU__SUCCESS);
  CHECK(stats().launches == 1);
  CHECK(end(S(0x500), &g) == CU__SUCCESS);
  /* thread-local: this thread's launches elsewhere go uncharged, another
   * thread's are charged */
  CHECK(begin(S(0x500), CU__STREAM_CAPTURE_MODE_THREAD_LOCAL) == CU__SUCCESS);
  CHECK(LAUNCH(g_launch, S(0x600)) == CU__SUCCESS);
  CHECK(stats().launches == 1);
  pthread_t thread;
  CHECK(pthread_create(&thread, NULL, launch_on_0x600, NULL) == 0);
  pthread_join(thread, NULL);
  CHECK(g_other_thread_launches == 1);
  CHECK(end(S(0x500), &g) == CU__SUCCESS);
  /* after the captures, everything is charged again */
  CHECK(LAUNCH(g_launch, S(0x600)) == CU__SUCCESS);
  CHECK(stats().launches == 3);
  CHECK(report_field("captured") == 2);
  CHECK(t.fake_count("capture_event_record") == 0);
  CHECK(t.fake_count("captured_launch") == 1);
  printf("PASS capture_modes: relaxed and another thread's thread-local captures leave "
         "other launches charged\n");
  return 0;
}

static int case_streams(void) {
  /* more streams than the hook's table holds (256), each destroyed */
  launch_kernel_fn launch = proc("cuLaunchKernel", CU__GET_PROC_ADDRESS_DEFAULT);
  stream_destroy_fn destroy = proc("cuStreamDestroy", CU__GET_PROC_ADDRESS_DEFAULT);
  CHECK((void*)destroy == dlsym(RTLD_DEFAULT, "cuStreamDestroy_v2"));
  CHECK(hook_metered() == 1);
  const int n = 300;
  for (int i = 0; i < n; ++i) {
    CHECK(LAUNCH(launch, S(0x10000 + 16 * i)) == CU__SUCCESS);
    CHECK(LAUNCH(launch, S(0x10000 + 16 * i)) == CU__SUCCESS);
    CHECK(destroy(S(0x10000 + 16 * i)) == CU__SUCCESS);
  }
  CHECK(LAUNCH(launch, S(0x100)) == CU__SUCCESS);   /* reads the last stream's window */
  stats_t s = stats();
  CHECK(s.launches == 2 * (uint64_t)n + 1);
  CHECK(s.device_us == 2 * (uint64_t)n * 100);      /* every launch timed */
  CHECK(report_field("unwindowed") == 0 && report_field("untimed") == 0);
  CHECK(report_field("streams_dropped") == (unsigned long long)n);
  CHECK(t.fake_count("stream_destroy") == (uint64_t)n);
  printf("PASS streams: %d streams destroyed, %llu us timed\n", n,
         (unsigned long long)s.device_us);
  return 0;
}

static uint64_t segment_used(uint64_t limit) {
  tfl_charge_result_t r;
  CHECK(t.charge_hbm(0, 0, &r) == 0 && r.allowed);
  return limit - r.available;
}

static int case_memory(void) {
  const uint64_t limit = 5 * MIB / 2;
  mem_alloc_fn alloc = proc("cuMemAlloc", CU__GET_PROC_ADDRESS_DEFAULT);
  mem_free_fn release_ptr = proc("cuMemFree", CU__GET_PROC_ADDRESS_DEFAULT);
  mem_create_fn create = proc("cuMemCreate", CU__GET_PROC_ADDRESS_DEFAULT);
  mem_release_fn release = proc("cuMemRelease", CU__GET_PROC_ADDRESS_DEFAULT);
  mem_alloc_async_fn alloc_async =
      proc("cuMemAllocAsync", CU__GET_PROC_ADDRESS_PER_THREAD_DEFAULT_STREAM);
  mem_free_async_fn free_async =
      proc("cuMemFreeAsync", CU__GET_PROC_ADDRESS_PER_THREAD_DEFAULT_STREAM);
  CHECK(hook_metered() == 1);
  cu_deviceptr_t a = 0, c = 0;
  cu_mem_handle_t b = 0;
  CHECK(alloc(&a, MIB) == CU__SUCCESS);
  CHECK(create(&b, MIB, NULL, 0) == CU__SUCCESS);
  CHECK(alloc_async(&c, MIB, NULL) == CU__SUCCESS);   /* over the 2.5 MiB budget */
  stats_t s = stats();
  CHECK(s.hbm_charged_bytes == (int64_t)(3 * MIB));   /* all three tracked */
  CHECK(s.hbm_denied == 1);
  CHECK(segment_used(limit) == 2 * MIB);               /* two admitted */
  CHECK(free_async(c, NULL) == CU__SUCCESS);           /* releases nothing it was denied */
  CHECK(segment_used(limit) == 2 * MIB);
  CHECK(release_ptr(a) == CU__SUCCESS);
  CHECK(segment_used(limit) == MIB);
  CHECK(release(b) == CU__SUCCESS);
  CHECK(segment_used(limit) == 0);
  CHECK(release_ptr(a) == CU__SUCCESS);                /* a second free releases nothing */
  s = stats();
  CHECK(s.hbm_charged_bytes == 0);
  CHECK(t.fake_count("alloc") == 2 && t.fake_count("create") == 1);
  CHECK(t.fake_count("free") == 3 && t.fake_count("release") == 1);
  printf("PASS memory: 3 MiB tracked, 1 over budget, all released\n");
  return 0;
}

static int case_passthrough(void) {
  unsetenv("TPF_SHM_PATH");
  launch_kernel_fn launch = proc("cuLaunchKernel", CU__GET_PROC_ADDRESS_DEFAULT);
  graph_launch_fn graph = proc("cuGraphLaunch", CU__GET_PROC_ADDRESS_DEFAULT);
  mem_alloc_fn alloc = proc("cuMemAlloc", CU__GET_PROC_ADDRESS_DEFAULT);
  mem_free_fn release_ptr = proc("cuMemFree", CU__GET_PROC_ADDRESS_DEFAULT);
  for (int i = 0; i < 5; ++i) CHECK(LAUNCH(launch, S(0x100)) == CU__SUCCESS);
  CHECK(graph((cu_graph_exec_t)0x77, S(0x100)) == CU__SUCCESS);
  cu_deviceptr_t a = 0;
  CHECK(alloc(&a, MIB) == CU__SUCCESS);
  CHECK(release_ptr(a) == CU__SUCCESS);
  CHECK(hook_metered() == 0);
  stats_t s = stats();
  CHECK(s.launches == 0 && s.charged_mflops == 0 && s.device_us == 0);
  CHECK(s.hbm_charged_bytes == 0 && s.hbm_denied == 0);
  CHECK(t.fake_count("launch") == 5 && t.fake_count("graph_launch") == 1);
  CHECK(t.fake_count("alloc") == 1 && t.fake_count("free") == 1);
  CHECK(t.fake_count("event_record") == 0);
  char buf[8192];
  CHECK(t.report(buf, sizeof(buf)) > 0);
  CHECK(strstr(buf, "\"cuLaunchKernel\": 5,") && strstr(buf, "\"cuGraphLaunch\": 1,"));
  printf("PASS passthrough: every call reached the driver, nothing charged\n");
  return 0;
}

static uint64_t g_seen_while_frozen = UINT64_MAX;

static void* thaw_later(void* arg) {
  (void)arg;
  struct timespec ts = {0, 300 * 1000 * 1000};
  nanosleep(&ts, NULL);
  g_seen_while_frozen = t.fake_count("launch");
  CHECK(t.set_frozen("t", "w", 0, 0) == 0);
  return NULL;
}

static int case_freeze(void) {
  launch_kernel_fn launch = proc("cuLaunchKernel", CU__GET_PROC_ADDRESS_DEFAULT);
  CHECK(hook_metered() == 1);
  CHECK(t.set_frozen("t", "w", 1, 0) == 0);
  pthread_t thread;
  CHECK(pthread_create(&thread, NULL, thaw_later, NULL) == 0);
  double t0 = now_s();
  CHECK(LAUNCH(launch, S(0x100)) == CU__SUCCESS);
  double waited = now_s() - t0;
  pthread_join(thread, NULL);
  CHECK(g_seen_while_frozen == 0);   /* nothing reached the driver while frozen */
  CHECK(waited >= 0.25);
  CHECK(stats().blocked_us > 0);
  CHECK(t.fake_count("launch") == 1);
  printf("PASS freeze: the launch waited %.2fs for the thaw\n", waited);
  return 0;
}

static int case_rtld_next(void) {
  /* from this program, the next object is the preloaded hook */
  CHECK(dlsym(RTLD_NEXT, "tpf_cuda_hook_metered") != NULL);
  CHECK(dlsym(RTLD_NEXT, "dlsym") == (void*)dlsym);
  printf("PASS rtld_next: RTLD_NEXT resolves from its caller\n");
  return 0;
}

static double time_launches(launch_kernel_fn fn, int n) {
  double t0 = now_s();
  for (int i = 0; i < n; ++i)
    if (LAUNCH(fn, S(0x100)) != CU__SUCCESS) return -1.0;
  return now_s() - t0;
}

static int bench(void) {
  launch_kernel_fn hooked = proc("cuLaunchKernel", CU__GET_PROC_ADDRESS_DEFAULT);
  launch_kernel_fn direct = (launch_kernel_fn)dlsym(t.cuda, "tpf_fake_launch_kernel");
  CHECK(direct != NULL && (void*)direct != (void*)hooked);
  CHECK(hook_metered() == 1);
  const int warm = 1000, n = 200000, rounds = 5, per = n / rounds;
  CHECK(time_launches(hooked, warm) >= 0 && time_launches(direct, warm) >= 0);
  double direct_best = 1e99, hook_best = 1e99;
  for (int r = 0; r < rounds; ++r) {   /* interleaved, so drift hits both */
    double d = time_launches(direct, per), h = time_launches(hooked, per);
    CHECK(d >= 0 && h >= 0);
    if (d < direct_best) direct_best = d;
    if (h < hook_best) hook_best = h;
  }
  double direct_ns = direct_best / per * 1e9, hook_ns = hook_best / per * 1e9;
  printf("{\"metric\": \"cuda_hook_launch_overhead_ns\", \"value\": %.1f, "
         "\"unit\": \"ns/launch\", \"direct_ns\": %.1f, \"hook_ns\": %.1f, "
         "\"launches\": %d}\n",
         hook_ns - direct_ns, direct_ns, hook_ns, n);
  return 0;
}

int main(int argc, char** argv) {
  if (argc != 4) {
    fprintf(stderr, "usage: %s <limiter.so> <shm_base> <case|--bench>\n", argv[0]);
    return 2;
  }
  const char* limiter_path = argv[1];
  const char* shm_base = argv[2];
  const char* which = argv[3];
  open_libraries(limiter_path);

  int rc;
  if (strcmp(which, "rtld_next") == 0) return case_rtld_next();
  if (strcmp(which, "block") == 0) {
    setenv("TPF_PEAK_MFLOPS", "100000", 1);
    setenv("TPF_FAKE_CUDA_LAUNCH_US", "1000", 1);
    make_worker(limiter_path, shm_base, 0, 200, 1000);
    open_driver();
    rc = case_block();
  } else if (strcmp(which, "charge") == 0) {
    setenv("TPF_PEAK_MFLOPS", "989000000", 1);
    setenv("TPF_FAKE_CUDA_LAUNCH_US", "250", 1);
    make_worker(limiter_path, shm_base, 0, UINT64_C(1) << 50, UINT64_C(1) << 50);
    open_driver();
    rc = case_charge();
  } else if (strcmp(which, "window") == 0) {
    setenv("TPF_FAKE_CUDA_LAUNCH_US", "1000", 1);
    setenv("TPF_FAKE_CUDA_LAG", "2", 1);
    make_worker(limiter_path, shm_base, 0, UINT64_C(1) << 50, UINT64_C(1) << 50);
    open_driver();
    rc = case_window();
  } else if (strcmp(which, "sync") == 0) {
    setenv("TPF_FAKE_CUDA_LAUNCH_US", "1000", 1);
    setenv("TPF_FAKE_CUDA_LAG", "3", 1);
    make_worker(limiter_path, shm_base, 0, UINT64_C(1) << 50, UINT64_C(1) << 50);
    open_driver();
    rc = case_sync();
  } else if (strcmp(which, "capture") == 0) {
    make_worker(limiter_path, shm_base, 0, UINT64_C(1) << 50, UINT64_C(1) << 50);
    open_driver();
    rc = case_capture();
  } else if (strcmp(which, "capture_modes") == 0) {
    make_worker(limiter_path, shm_base, 0, UINT64_C(1) << 50, UINT64_C(1) << 50);
    open_driver();
    rc = case_capture_modes();
  } else if (strcmp(which, "streams") == 0) {
    make_worker(limiter_path, shm_base, 0, UINT64_C(1) << 50, UINT64_C(1) << 50);
    open_driver();
    rc = case_streams();
  } else if (strcmp(which, "memory") == 0) {
    make_worker(limiter_path, shm_base, 5 * MIB / 2, UINT64_C(1) << 50, UINT64_C(1) << 50);
    open_driver();
    rc = case_memory();
  } else if (strcmp(which, "passthrough") == 0) {
    open_driver();
    rc = case_passthrough();
  } else if (strcmp(which, "freeze") == 0) {
    make_worker(limiter_path, shm_base, 0, UINT64_C(1) << 50, UINT64_C(1) << 50);
    open_driver();
    rc = case_freeze();
  } else if (strcmp(which, "--bench") == 0) {
    make_worker(limiter_path, shm_base, 0, UINT64_C(1) << 50, UINT64_C(1) << 50);
    open_driver();
    return bench();
  } else {
    fprintf(stderr, "unknown case %s\n", which);
    return 2;
  }
  print_report();
  return rc;
}
