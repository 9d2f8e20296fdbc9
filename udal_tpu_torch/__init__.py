"""udal_tpu_torch — the PyTorch/CUDA port of ``udal_tpu``.

The serving path of the JAX package (10-pass MC-dropout EfficientDet with
loss attenuation, l-norm uncertainty decoding and gaussian soft-NMS) in
PyTorch, with the soft-NMS as a CUDA kernel written for Hopper
(``csrc/soft_nms.cu``); training, calibration, thresholding, auto-labeling
and validation. Module paths mirror ``udal_tpu`` so each piece sits beside
its reference. Imports ``torch``, ``numpy`` and ``scipy`` only.
"""

__version__ = "0.1.0"
