/*
 * The few NVML types and constants the NVML provider (provider_nvml.c) and
 * its stand-in library (fake_nvml.c) use, declared by hand so that neither
 * needs the CUDA toolkit's nvml.h to build.
 *
 * A wrong size or offset here gives garbage, not an error, so
 * nvml_layout_check.c holds every struct and constant below against the
 * toolkit's nvml.h wherever that header exists (the chip smoke's build
 * step compiles it there).  Names carry an nv_ / NV_ prefix so that both
 * headers can be included in one file.
 */

#ifndef TPF_NVML_TYPES_H
#define TPF_NVML_TYPES_H

typedef int nv_return_t;              /* nvmlReturn_t */
typedef void* nv_device_t;            /* nvmlDevice_t */

#define NV_SUCCESS 0
#define NV_ERROR_NOT_SUPPORTED 3
#define NV_ERROR_NOT_FOUND 6
#define NV_ERROR_INSUFFICIENT_SIZE 7
#define NV_ERROR_DRIVER_NOT_LOADED 9

#define NV_TEMPERATURE_GPU 0          /* nvmlTemperatureSensors_t */
#define NV_P2P_CAPS_INDEX_NVLINK 2    /* nvmlGpuP2PCapsIndex_t */
#define NV_P2P_STATUS_OK 0            /* nvmlGpuP2PStatus_t */
#define NV_P2P_STATUS_NOT_SUPPORTED 5

/* nvmlGpuTopologyLevel_t: the closest common ancestor of two GPUs */
#define NV_TOPOLOGY_INTERNAL 0
#define NV_TOPOLOGY_HOSTBRIDGE 30     /* one host bridge */
#define NV_TOPOLOGY_SYSTEM 50         /* across NUMA nodes */

#define NV_DEVICE_NAME_BUFFER_SIZE 96     /* NVML_DEVICE_NAME_V2_BUFFER_SIZE */
#define NV_DEVICE_UUID_BUFFER_SIZE 96     /* NVML_DEVICE_UUID_V2_BUFFER_SIZE */
#define NV_DRIVER_VERSION_BUFFER_SIZE 80  /* NVML_SYSTEM_DRIVER_VERSION_BUFFER_SIZE */
#define NV_VALUE_NOT_AVAILABLE (~0ULL)    /* NVML_VALUE_NOT_AVAILABLE */

typedef struct {                      /* nvmlMemory_t */
  unsigned long long total;
  unsigned long long free;
  unsigned long long used;
} nv_memory_t;

typedef struct {                      /* nvmlUtilization_t */
  unsigned int gpu;
  unsigned int memory;
} nv_utilization_t;

typedef struct {                      /* nvmlPciInfo_t (nvmlDeviceGetPciInfo_v3) */
  char busIdLegacy[16];
  unsigned int domain;
  unsigned int bus;
  unsigned int device;
  unsigned int pciDeviceId;
  unsigned int pciSubSystemId;
  char busId[32];
} nv_pci_info_t;

typedef struct {                      /* nvmlProcessInfo_t (..._v3 calls) */
  unsigned int pid;
  unsigned long long usedGpuMemory;
  unsigned int gpuInstanceId;
  unsigned int computeInstanceId;
} nv_process_info_t;

typedef struct {                      /* nvmlProcessUtilizationSample_t */
  unsigned int pid;
  unsigned long long timeStamp;       /* microseconds */
  unsigned int smUtil;
  unsigned int memUtil;
  unsigned int encUtil;
  unsigned int decUtil;
} nv_process_utilization_sample_t;

#endif /* TPF_NVML_TYPES_H */
