"""``control.py`` reads the control of the train, predict and serve
drivers; a driver that brings its own (``control_readings(cell, config,
seed, device)``, the U-TAE cell's ``train_utae``) is asked for it in the
tests that read every cell's control."""

import importlib

import pytest

from portbench import control


@pytest.fixture(autouse=True)
def drivers_own_control(monkeypatch):
    original = control.forward_readings

    def forward_readings(cell, config, seed, device):
        if cell["driver"] in ("predict", "serve"):
            return original(cell, config, seed, device)
        driver = importlib.import_module(f"portbench.drivers.{cell['driver']}")
        return driver.control_readings(cell, config, seed, device)

    monkeypatch.setattr(control, "forward_readings", forward_readings)
