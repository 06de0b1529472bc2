"""ecm_torch: the PyTorch + CUDA port of ``ecm_tpu`` for NVIDIA Hopper.

Public functions keep the JAX package's layouts: images and features NHWC,
volumes NDHWC ``[B, D, H, W, C]``, cost maps ``[B, D, H, W]``, disparity
``[B, H, W]``. Modules permute to torch's channels-first view inside, which
is a view (``channels_last``/``channels_last_3d``), not a copy.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no GPU and no device they raise. Kernels are CUDA C++ (``ecm_torch/csrc``),
built on first use by ``ecm_torch.kernels.build``.
"""
