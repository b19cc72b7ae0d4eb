"""The paper's own evaluation configurations (§IV): TeraRack WDM ring sweeps.

A copy of ``repro/configs/optree_paper.py``; like the original it is not in
the model registry and is imported by name.
"""
from ..core.cost_model import OpticalSystem

#: §IV-A defaults
SYSTEM = OpticalSystem()

#: Fig. 4: depth sweep
FIG4_NODES = (512, 1024, 2048, 4096)
FIG4_MESSAGE_BYTES = 4 * 2**20
FIG4_DEPTHS = tuple(range(1, 11))

#: Fig. 5: message-size sweep at w=64
FIG5_NODES = (1024, 2048)
FIG5_MESSAGES = tuple(m * 2**20 for m in (4, 8, 16, 32, 64, 128))

#: Fig. 6: wavelength sweep at N=1024
FIG6_WAVELENGTHS = (96, 128)
FIG6_MESSAGES = FIG5_MESSAGES

#: Table I
TABLE1_N = 1024
TABLE1_W = 64
