"""Device-mesh helpers for the (channel, time) 2-D sharding layout.

The reference's only parallelism is a 6-thread pipeline on one CPU
(src/receiver_chain.cpp:58-95). The device scaling axes are different
and orthogonal to the algorithm:

  * `channel` - independent RF channels (and/or independent captures):
    embarrassingly parallel, no communication.
  * `time`    - one long capture split into overlap-save blocks; each
    device needs its right neighbor's head (halo) to decode frames that
    straddle the boundary; the exchange is a single ppermute over ICI.

Meshes are plain jax.sharding.Mesh objects; nothing here touches real
hardware until arrays are placed.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(devices=None, channel: int | None = None,
              time: int | None = None) -> Mesh:
    """Build a (channel, time) mesh over the given (or all) devices.

    If only one of channel/time is given the other is inferred; default
    splits devices as evenly as possible with channel-major ordering.
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if channel is None and time is None:
        channel = int(2 ** int(np.floor(np.log2(max(n, 1)) / 2)))
        time = n // channel
    elif channel is None:
        channel = n // time
    elif time is None:
        time = n // channel
    if channel * time != n:
        raise ValueError(f"mesh {channel}x{time} != {n} devices")
    arr = np.asarray(devices).reshape(channel, time)
    return Mesh(arr, ("channel", "time"))
