from .serving import (Candidate, FleetSession, NavDecision, NavFleet,
                      NavServer, NavSession, Observation,
                      observation_from_world)
