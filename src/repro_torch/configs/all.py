"""Imports every architecture config so the registry is populated."""
from repro_torch.configs import (nemotron_4_340b, minitron_8b,  # noqa
                                 smollm_135m, command_r_plus_104b,
                                 hubert_xlarge, deepseek_v2_236b,
                                 phi35_moe_42b, mamba2_370m, jamba_v01_52b,
                                 chameleon_34b, paper_flow)
