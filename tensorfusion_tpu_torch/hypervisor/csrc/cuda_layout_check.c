/*
 * Holds the hand-declared CUDA driver types of cuda_types.h against the
 * CUDA toolkit's cuda.h: the build fails (a static assertion) on any size,
 * field offset or constant that differs.  Compiled only where the toolkit
 * is installed:
 *
 *   cc -std=c11 -fsyntax-only -I$CUDA_HOME/include cuda_layout_check.c
 */

#include <stddef.h>

#include <cuda.h>

#include "cuda_types.h"

#define SAME_SIZE(ours, theirs) \
  _Static_assert(sizeof(ours) == sizeof(theirs), #ours " differs in size from " #theirs)
#define SAME_FIELD(ours, theirs, field)                                          \
  _Static_assert(offsetof(ours, field) == offsetof(theirs, field) &&            \
                     sizeof(((ours*)0)->field) == sizeof(((theirs*)0)->field),  \
                 #theirs "." #field " differs")
#define SAME_VALUE(ours, theirs) _Static_assert((ours) == (theirs), #ours " != " #theirs)

SAME_SIZE(cu_result_t, CUresult);
SAME_SIZE(cu_deviceptr_t, CUdeviceptr);
SAME_SIZE(cu_stream_t, CUstream);
SAME_SIZE(cu_function_t, CUfunction);
SAME_SIZE(cu_graph_exec_t, CUgraphExec);
SAME_SIZE(cu_graph_t, CUgraph);
SAME_SIZE(cu_event_t, CUevent);
SAME_SIZE(cu_mem_pool_t, CUmemoryPool);
SAME_SIZE(cu_mem_handle_t, CUmemGenericAllocationHandle);
SAME_SIZE(cu_uint64_t, cuuint64_t);
SAME_SIZE(cu_capture_status_t, CUstreamCaptureStatus);
SAME_SIZE(cu_capture_mode_t, CUstreamCaptureMode);
SAME_SIZE(cu_proc_query_result_t, CUdriverProcAddressQueryResult);

SAME_SIZE(cu_launch_config_t, CUlaunchConfig);
SAME_FIELD(cu_launch_config_t, CUlaunchConfig, gridDimX);
SAME_FIELD(cu_launch_config_t, CUlaunchConfig, gridDimY);
SAME_FIELD(cu_launch_config_t, CUlaunchConfig, gridDimZ);
SAME_FIELD(cu_launch_config_t, CUlaunchConfig, blockDimX);
SAME_FIELD(cu_launch_config_t, CUlaunchConfig, blockDimY);
SAME_FIELD(cu_launch_config_t, CUlaunchConfig, blockDimZ);
SAME_FIELD(cu_launch_config_t, CUlaunchConfig, sharedMemBytes);
SAME_FIELD(cu_launch_config_t, CUlaunchConfig, hStream);
SAME_FIELD(cu_launch_config_t, CUlaunchConfig, attrs);
SAME_FIELD(cu_launch_config_t, CUlaunchConfig, numAttrs);

SAME_VALUE(CU__SUCCESS, CUDA_SUCCESS);
SAME_VALUE(CU__ERROR_INVALID_VALUE, CUDA_ERROR_INVALID_VALUE);
SAME_VALUE(CU__ERROR_NOT_FOUND, CUDA_ERROR_NOT_FOUND);
SAME_VALUE(CU__ERROR_NOT_READY, CUDA_ERROR_NOT_READY);
SAME_VALUE(CU__GET_PROC_ADDRESS_DEFAULT, CU_GET_PROC_ADDRESS_DEFAULT);
SAME_VALUE(CU__GET_PROC_ADDRESS_LEGACY_STREAM, CU_GET_PROC_ADDRESS_LEGACY_STREAM);
SAME_VALUE(CU__GET_PROC_ADDRESS_PER_THREAD_DEFAULT_STREAM,
           CU_GET_PROC_ADDRESS_PER_THREAD_DEFAULT_STREAM);
SAME_VALUE(CU__GET_PROC_ADDRESS_SUCCESS, CU_GET_PROC_ADDRESS_SUCCESS);
SAME_VALUE(CU__GET_PROC_ADDRESS_SYMBOL_NOT_FOUND, CU_GET_PROC_ADDRESS_SYMBOL_NOT_FOUND);
SAME_VALUE(CU__GET_PROC_ADDRESS_VERSION_NOT_SUFFICIENT,
           CU_GET_PROC_ADDRESS_VERSION_NOT_SUFFICIENT);
SAME_VALUE(CU__STREAM_CAPTURE_STATUS_NONE, CU_STREAM_CAPTURE_STATUS_NONE);
SAME_VALUE(CU__STREAM_CAPTURE_STATUS_ACTIVE, CU_STREAM_CAPTURE_STATUS_ACTIVE);
SAME_VALUE(CU__STREAM_CAPTURE_STATUS_INVALIDATED, CU_STREAM_CAPTURE_STATUS_INVALIDATED);
SAME_VALUE(CU__STREAM_CAPTURE_MODE_GLOBAL, CU_STREAM_CAPTURE_MODE_GLOBAL);
SAME_VALUE(CU__STREAM_CAPTURE_MODE_THREAD_LOCAL, CU_STREAM_CAPTURE_MODE_THREAD_LOCAL);
SAME_VALUE(CU__STREAM_CAPTURE_MODE_RELAXED, CU_STREAM_CAPTURE_MODE_RELAXED);
SAME_VALUE(CU__EVENT_DEFAULT, CU_EVENT_DEFAULT);

/* the pseudo stream handles are casts of integers in both headers */
_Static_assert((size_t)CU__STREAM_LEGACY == (size_t)CU_STREAM_LEGACY, "CU_STREAM_LEGACY");
_Static_assert((size_t)CU__STREAM_PER_THREAD == (size_t)CU_STREAM_PER_THREAD,
               "CU_STREAM_PER_THREAD");
