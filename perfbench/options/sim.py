"""The deploy option ``sim``: a simulated analog device, given in a
configuration as plain data, as the program's ``ImcSimConfig``."""


def make(sim: dict):
    from repro_torch.core.types import ImcArrayConfig, ImcSimConfig
    return ImcSimConfig(arr=ImcArrayConfig(rows=sim["rows"], cols=sim["cols"]),
                        adc_bits=sim["adc_bits"],
                        adc_clip=sim.get("adc_clip"),
                        noise_sigma=sim["noise_sigma"],
                        fault_p0=sim["fault_p0"], fault_p1=sim["fault_p1"],
                        drift_sigma=sim["drift_sigma"], seed=sim["seed"])
