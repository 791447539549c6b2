"""The share of the time in which no kernel ran on the device, in %, per
train step: `device_idle.eval.py`'s reading, whose steps are here train
steps."""

from h100_bench.harness import metric_module

read = metric_module("device_idle.eval").read
