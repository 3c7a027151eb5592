from repro_torch.data.synthetic import synthetic_setup, synthetic_trajectories
from repro_torch.data.geolife import geolife_surrogate
from repro_torch.data.fig1 import fig1_world
