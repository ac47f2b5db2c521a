"""Part of the vins_tpu_torch port; see the package docstring."""
