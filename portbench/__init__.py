"""The benchmark of ``kafkabalancer_tpu_torch``: closed-loop clients of the
port's planning daemon on one CUDA card. ``python3 portbench/run.py
--workload <cell> --seed <n> --seconds <s> --trace <0|1>``."""
