from fos_tpu_torch.interface.api import solve  # noqa: F401
