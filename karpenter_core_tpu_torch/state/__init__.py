from .statenode import StateNode
