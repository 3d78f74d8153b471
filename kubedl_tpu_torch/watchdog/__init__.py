"""The port's copy of the worker-side progress beacon (``kubedl_tpu/watchdog``)."""
