"""Elastic resize of the port: the math the operator and every worker
must agree on (a copy of the reference's ``kubedl_tpu/elastic``)."""
