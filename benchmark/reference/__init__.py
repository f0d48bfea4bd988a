"""The benchmark's plain reference (render.py), its frozen copy of the
port's render path (plain/) and the bfloat16 control (control.py)."""
