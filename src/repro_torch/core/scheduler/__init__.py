"""The paper's batch scheduler: jobs, the device model, the event kernel,
the baseline and Schemes A and B (own copies of ``repro.core.scheduler``).

Host code that models the device; nothing here launches work on a card.
"""
