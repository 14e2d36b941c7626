"""Production-host site shape: ten 2.4 MS/s RTL-SDR-class sources, 64
slots each, mixed trunked systems (the reference's den940 radio host:
configs/config_denver_prod_den940radio1.py:21-114, ten dongles feeding
one machine). The sources here replay complex64 capture files
``capture_src<N>.c64`` from the working directory; ``chip_smoke.py``
drives the same configuration from synthetic in-memory captures.

    python -m radiocapture_tpu.runtime -c configs/config_site_10rtl.py \
        --blocks 40
"""

config = RcConfig()                         # noqa: F821 (injected)
config.site_uuid = "00000000-0000-0000-0000-0000000s1te"
config.num_slots_per_source = 64
config.block_seconds = 0.1
config.frontend_mode = "xlat"
config.group_sources = True

_CENTERS = [857.0e6, 852.2e6, 854.6e6, 859.4e6, 861.8e6,
            864.2e6, 866.6e6, 869.0e6, 771.0e6, 773.4e6]
for _i, _fc in enumerate(_CENTERS):
    config.sources[_i] = SourceConfig(      # noqa: F821
        type="file", args=f"capture_src{_i}.c64",
        center_freq=_fc, samp_rate=2.4e6)

config.systems[0] = SystemConfig(           # noqa: F821
    type="p25", id="Metro P25", modulation="C4FM",
    control_channels=[857.5e6],
    system_uuid="00000000-0000-0000-0000-00000000p25a",
    transmit_site_uuid="00000000-0000-0000-0000-00000000t25a",
)
config.systems[1] = SystemConfig(           # noqa: F821
    type="p25", id="County P25", modulation="C4FM",
    control_channels=[862.3e6, 862.8e6],
)
config.systems[2] = SystemConfig(           # noqa: F821
    type="edacs", id="City EDACS",
    channels={1: 866.3e6, 2: 866.8e6, 3: 867.3e6},
)
config.systems[3] = SystemConfig(           # noqa: F821
    type="moto", id="Legacy Type II",
    channels={1: 771.1e6, 2: 771.6e6},
)
