"""DeviceImage — explicit host↔device image container.

Counterpart of the reference's ``DeviceImage<T>`` (include/cuda/device_image.hpp:4,
src/device_image.cu), which is a thrust-backed W×H×C device buffer with
upload/download.  On the device the runtime equivalent is a committed jax.Array;
this wrapper keeps the familiar API (upload / download / get) and pins the
buffer to a chosen device.  jitted ops consume it with zero copies.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


class DeviceImage:
    def __init__(self, height: int, width: int, channels: int = 3,
                 dtype=jnp.uint8, device=None):
        self.shape = (height, width, channels)
        self.dtype = jnp.dtype(dtype)
        self.device = device if device is not None else jax.devices()[0]
        self._buf = jax.device_put(jnp.zeros(self.shape, self.dtype), self.device)

    @classmethod
    def from_array(cls, array, device=None) -> "DeviceImage":
        array = np.asarray(array)
        if array.ndim == 2:
            array = array[:, :, None]
        img = cls(*array.shape, dtype=array.dtype, device=device)
        img.upload(array)
        return img

    def upload(self, host_array) -> None:
        host_array = np.asarray(host_array)
        if host_array.ndim == 2:
            host_array = host_array[:, :, None]
        if host_array.shape != self.shape:
            raise ValueError(f"shape {host_array.shape} != {self.shape}")
        self._buf = jax.device_put(jnp.asarray(host_array, self.dtype), self.device)

    def download(self) -> np.ndarray:
        return np.asarray(self._buf)

    def get(self) -> jax.Array:
        """The device buffer (zero-copy view for jitted ops)."""
        return self._buf

    def set(self, device_array: jax.Array) -> None:
        if device_array.shape != self.shape:
            raise ValueError(f"shape {device_array.shape} != {self.shape}")
        self._buf = device_array
