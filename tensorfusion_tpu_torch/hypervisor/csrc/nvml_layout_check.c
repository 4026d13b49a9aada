/*
 * Holds the hand-declared NVML types of nvml_types.h against the CUDA
 * toolkit's nvml.h: the build fails (a static assertion) on any size,
 * field offset or constant that differs.  Compiled only where the toolkit
 * is installed:
 *
 *   cc -std=c11 -fsyntax-only -I$CUDA_HOME/include nvml_layout_check.c
 */

#include <stddef.h>

#include <nvml.h>

#include "nvml_types.h"

#define SAME_SIZE(ours, theirs) \
  _Static_assert(sizeof(ours) == sizeof(theirs), #ours " differs in size from " #theirs)
#define SAME_FIELD(ours, theirs, field)                                          \
  _Static_assert(offsetof(ours, field) == offsetof(theirs, field) &&            \
                     sizeof(((ours*)0)->field) == sizeof(((theirs*)0)->field),  \
                 #theirs "." #field " differs")
#define SAME_VALUE(ours, theirs) _Static_assert((ours) == (theirs), #ours " != " #theirs)

SAME_SIZE(nv_device_t, nvmlDevice_t);
SAME_SIZE(nv_return_t, nvmlReturn_t);

SAME_SIZE(nv_memory_t, nvmlMemory_t);
SAME_FIELD(nv_memory_t, nvmlMemory_t, total);
SAME_FIELD(nv_memory_t, nvmlMemory_t, free);
SAME_FIELD(nv_memory_t, nvmlMemory_t, used);

SAME_SIZE(nv_utilization_t, nvmlUtilization_t);
SAME_FIELD(nv_utilization_t, nvmlUtilization_t, gpu);
SAME_FIELD(nv_utilization_t, nvmlUtilization_t, memory);

SAME_SIZE(nv_pci_info_t, nvmlPciInfo_t);
SAME_FIELD(nv_pci_info_t, nvmlPciInfo_t, busIdLegacy);
SAME_FIELD(nv_pci_info_t, nvmlPciInfo_t, domain);
SAME_FIELD(nv_pci_info_t, nvmlPciInfo_t, bus);
SAME_FIELD(nv_pci_info_t, nvmlPciInfo_t, device);
SAME_FIELD(nv_pci_info_t, nvmlPciInfo_t, pciDeviceId);
SAME_FIELD(nv_pci_info_t, nvmlPciInfo_t, pciSubSystemId);
SAME_FIELD(nv_pci_info_t, nvmlPciInfo_t, busId);

SAME_SIZE(nv_process_info_t, nvmlProcessInfo_t);
SAME_FIELD(nv_process_info_t, nvmlProcessInfo_t, pid);
SAME_FIELD(nv_process_info_t, nvmlProcessInfo_t, usedGpuMemory);
SAME_FIELD(nv_process_info_t, nvmlProcessInfo_t, gpuInstanceId);
SAME_FIELD(nv_process_info_t, nvmlProcessInfo_t, computeInstanceId);

SAME_SIZE(nv_process_utilization_sample_t, nvmlProcessUtilizationSample_t);
SAME_FIELD(nv_process_utilization_sample_t, nvmlProcessUtilizationSample_t, pid);
SAME_FIELD(nv_process_utilization_sample_t, nvmlProcessUtilizationSample_t, timeStamp);
SAME_FIELD(nv_process_utilization_sample_t, nvmlProcessUtilizationSample_t, smUtil);
SAME_FIELD(nv_process_utilization_sample_t, nvmlProcessUtilizationSample_t, memUtil);
SAME_FIELD(nv_process_utilization_sample_t, nvmlProcessUtilizationSample_t, encUtil);
SAME_FIELD(nv_process_utilization_sample_t, nvmlProcessUtilizationSample_t, decUtil);

SAME_VALUE(NV_SUCCESS, NVML_SUCCESS);
SAME_VALUE(NV_ERROR_NOT_SUPPORTED, NVML_ERROR_NOT_SUPPORTED);
SAME_VALUE(NV_ERROR_NOT_FOUND, NVML_ERROR_NOT_FOUND);
SAME_VALUE(NV_ERROR_INSUFFICIENT_SIZE, NVML_ERROR_INSUFFICIENT_SIZE);
SAME_VALUE(NV_ERROR_DRIVER_NOT_LOADED, NVML_ERROR_DRIVER_NOT_LOADED);
SAME_VALUE(NV_TEMPERATURE_GPU, NVML_TEMPERATURE_GPU);
SAME_VALUE(NV_P2P_CAPS_INDEX_NVLINK, NVML_P2P_CAPS_INDEX_NVLINK);
SAME_VALUE(NV_P2P_STATUS_OK, NVML_P2P_STATUS_OK);
SAME_VALUE(NV_P2P_STATUS_NOT_SUPPORTED, NVML_P2P_STATUS_NOT_SUPPORTED);
SAME_VALUE(NV_TOPOLOGY_INTERNAL, NVML_TOPOLOGY_INTERNAL);
SAME_VALUE(NV_TOPOLOGY_HOSTBRIDGE, NVML_TOPOLOGY_HOSTBRIDGE);
SAME_VALUE(NV_TOPOLOGY_SYSTEM, NVML_TOPOLOGY_SYSTEM);
SAME_VALUE(NV_DEVICE_NAME_BUFFER_SIZE, NVML_DEVICE_NAME_V2_BUFFER_SIZE);
SAME_VALUE(NV_DEVICE_UUID_BUFFER_SIZE, NVML_DEVICE_UUID_V2_BUFFER_SIZE);
SAME_VALUE(NV_DRIVER_VERSION_BUFFER_SIZE, NVML_SYSTEM_DRIVER_VERSION_BUFFER_SIZE);
SAME_VALUE(NV_VALUE_NOT_AVAILABLE, NVML_VALUE_NOT_AVAILABLE);
