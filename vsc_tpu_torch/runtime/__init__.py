"""The multi-video control plane of the port: workflow state (YAML),
filesystem metrics, the orchestrator that runs the step CLIs as child
processes, and its dashboard. Host code only: nothing here imports torch.

    python -m vsc_tpu_torch.runtime.orchestrator workflows.yaml [--cpu]
"""
