"""The paper's five applications (§VII) on the in-process PE cube."""
