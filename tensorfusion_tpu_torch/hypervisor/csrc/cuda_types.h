/*
 * The few CUDA driver types and constants the launch and memory hook
 * (cuda_hook.c), its stand-in driver (fake_cuda.c) and its selftest use,
 * declared by hand so that none of them needs the CUDA toolkit's cuda.h
 * to build.
 *
 * A wrong size or offset here gives garbage, not an error, so
 * cuda_layout_check.c holds every struct and constant below against the
 * toolkit's cuda.h wherever that header exists (the chip smoke's build
 * step compiles it there).  Names carry a cu_ / CU__ prefix so that both
 * headers can be included in one file.
 */

#ifndef TPF_CUDA_TYPES_H
#define TPF_CUDA_TYPES_H

#include <stddef.h>
#include <stdint.h>

typedef int cu_result_t;                       /* CUresult */
typedef unsigned long long cu_deviceptr_t;     /* CUdeviceptr (_v2) */
typedef struct cu_stream_st* cu_stream_t;      /* CUstream */
typedef struct cu_func_st* cu_function_t;      /* CUfunction */
typedef struct cu_graph_exec_st* cu_graph_exec_t;  /* CUgraphExec */
typedef struct cu_graph_st* cu_graph_t;        /* CUgraph */
typedef struct cu_event_st* cu_event_t;        /* CUevent */
typedef struct cu_mem_pool_st* cu_mem_pool_t;  /* CUmemoryPool */
typedef unsigned long long cu_mem_handle_t;    /* CUmemGenericAllocationHandle */
typedef uint64_t cu_uint64_t;                  /* cuuint64_t */
typedef int cu_capture_status_t;               /* CUstreamCaptureStatus */
typedef int cu_capture_mode_t;                 /* CUstreamCaptureMode */
typedef int cu_proc_query_result_t;            /* CUdriverProcAddressQueryResult */

#define CU__SUCCESS 0
#define CU__ERROR_INVALID_VALUE 1
#define CU__ERROR_NOT_FOUND 500
#define CU__ERROR_NOT_READY 600

/* CUdriverProcAddress_flags */
#define CU__GET_PROC_ADDRESS_DEFAULT 0
#define CU__GET_PROC_ADDRESS_LEGACY_STREAM 1
#define CU__GET_PROC_ADDRESS_PER_THREAD_DEFAULT_STREAM 2

/* CUdriverProcAddressQueryResult */
#define CU__GET_PROC_ADDRESS_SUCCESS 0
#define CU__GET_PROC_ADDRESS_SYMBOL_NOT_FOUND 1
#define CU__GET_PROC_ADDRESS_VERSION_NOT_SUFFICIENT 2

/* CUstreamCaptureStatus */
#define CU__STREAM_CAPTURE_STATUS_NONE 0
#define CU__STREAM_CAPTURE_STATUS_ACTIVE 1
#define CU__STREAM_CAPTURE_STATUS_INVALIDATED 2

/* CUstreamCaptureMode */
#define CU__STREAM_CAPTURE_MODE_GLOBAL 0
#define CU__STREAM_CAPTURE_MODE_THREAD_LOCAL 1
#define CU__STREAM_CAPTURE_MODE_RELAXED 2

#define CU__EVENT_DEFAULT 0x0                  /* CUevent_flags */

/* the pseudo stream handles: the legacy default stream and the calling
 * thread's per-thread default stream */
#define CU__STREAM_LEGACY ((cu_stream_t)0x1)
#define CU__STREAM_PER_THREAD ((cu_stream_t)0x2)

typedef struct cu_launch_attribute_st cu_launch_attribute_t; /* CUlaunchAttribute */
typedef struct cu_mem_allocation_prop_st cu_mem_allocation_prop_t; /* CUmemAllocationProp */

typedef struct {                               /* CUlaunchConfig */
  unsigned int gridDimX;
  unsigned int gridDimY;
  unsigned int gridDimZ;
  unsigned int blockDimX;
  unsigned int blockDimY;
  unsigned int blockDimZ;
  unsigned int sharedMemBytes;
  cu_stream_t hStream;
  cu_launch_attribute_t* attrs;
  unsigned int numAttrs;
} cu_launch_config_t;

#endif /* TPF_CUDA_TYPES_H */
