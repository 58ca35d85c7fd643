"""The benchmark of genconvit_tpu_torch on one H100: `python3 perfbench/run.py
--workload NAME --seed N --seconds S --trace 0|1` runs one cell once and
prints one JSON line. Everything a cell needs is found by name: its file in
`workloads/`, its configuration in `configs/`, its traffic mix in
`traffic/`, the driver its mix names in `drivers/`, and each per-layer
metric's reader in `metrics/`."""
