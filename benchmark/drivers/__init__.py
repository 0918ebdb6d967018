"""Drivers, one a traffic kind: a mix names its driver by file name."""
