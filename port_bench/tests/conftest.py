"""The CPU tests run in several workers at once: one thread each keeps
them from crowding the cores."""

import torch

torch.set_num_threads(1)
