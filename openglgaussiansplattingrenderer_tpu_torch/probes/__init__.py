"""Measurement probes of the port, each around one small CUDA kernel:
``bucketer_probe`` (one level of a bucketing sort) and ``cache_key_probe``
(does the kernel library's build digest survive a source edit that changes
no kernel). Run them on a machine with an NVIDIA GPU and nvcc:

    python3 -m openglgaussiansplattingrenderer_tpu_torch.probes.bucketer_probe
    python3 -m openglgaussiansplattingrenderer_tpu_torch.probes.cache_key_probe
"""
